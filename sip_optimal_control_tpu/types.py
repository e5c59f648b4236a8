"""Core problem-description types: tree topology, dimensions, validation.

A batched re-design of the reference front-end's L1 layer
(reference: sip_optimal_control/lqr.hpp:5-64, sip_optimal_control/types.hpp,
sip_optimal_control/types.cpp:68-134).  Unlike the C++ reference — which keeps
pointer tables and byte-exact workspace accounting — everything here is a
*static*, hashable problem descriptor resolved at trace time.  The solvers
consume stacked SoA device arrays whose shapes are derived from these
descriptors; no dynamic shapes ever reach XLA.

Topology compilation (child-CSR, preorder/postorder, level schedule) happens
once on the host, in NumPy or in the optional C++ helper
(native/topology.cpp); the resulting index arrays are baked into the jitted
program as constants.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np


class InputValidationStatus(enum.IntEnum):
    """Mirrors the reference's typed validation results
    (reference: sip_optimal_control/types.hpp:153-160)."""

    SUCCESS = 0
    INVALID_DIMENSIONS = 1
    INVALID_TOPOLOGY = 2


class FactorStatus(enum.IntEnum):
    """Per-scenario factorization status, carried as data through the batch
    (reference: sip_optimal_control/lqr.hpp:68-74).  Larger is worse; batched
    reductions take the max."""

    SUCCESS = 0
    INVALID_DELTA = 1
    F_FACTORIZATION_FAILURE = 2
    G_FACTORIZATION_FAILURE = 3
    INVALID_TOPOLOGY = 4


class TopologyError(ValueError):
    pass


class DimensionError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Topology:
    """Rooted-tree time structure (reference: sip_optimal_control/lqr.hpp:5-22).

    ``num_nodes == num_edges + 1``.  Every non-root node has exactly one
    incoming edge; edges point parent -> child.
    """

    num_edges: int
    root: int
    edge_parents: Tuple[int, ...]
    edge_children: Tuple[int, ...]

    @property
    def num_nodes(self) -> int:
        return self.num_edges + 1

    @staticmethod
    def chain(num_edges: int) -> "Topology":
        """Chain 0 -> 1 -> ... -> T (reference: lqr.cpp set_chain)."""
        return Topology(
            num_edges=num_edges,
            root=0,
            edge_parents=tuple(range(num_edges)),
            edge_children=tuple(range(1, num_edges + 1)),
        )

    @staticmethod
    def tree(root: int, edge_parents: Sequence[int],
             edge_children: Sequence[int]) -> "Topology":
        if len(edge_parents) != len(edge_children):
            raise TopologyError("edge_parents and edge_children length mismatch")
        return Topology(
            num_edges=len(edge_parents),
            root=root,
            edge_parents=tuple(int(p) for p in edge_parents),
            edge_children=tuple(int(c) for c in edge_children),
        )

    @cached_property
    def is_chain(self) -> bool:
        return (
            self.root == 0
            and self.edge_parents == tuple(range(self.num_edges))
            and self.edge_children == tuple(range(1, self.num_edges + 1))
        )


@dataclasses.dataclass(frozen=True)
class Dimensions:
    """Per-node / per-edge dimensions (reference: lqr.hpp:24-64, lqr.cpp:49-180).

    State and node-constraint dims are indexed by node id; control and
    edge-constraint dims by edge id.  ``theta_dim`` is the global/separator
    variable dimension (Schur-complemented in the KKT solve).
    """

    theta_dim: int
    state_dims: Tuple[int, ...]
    control_dims: Tuple[int, ...]
    node_c_dims: Tuple[int, ...]
    node_g_dims: Tuple[int, ...]
    edge_c_dims: Tuple[int, ...]
    edge_g_dims: Tuple[int, ...]

    @staticmethod
    def uniform(num_edges: int, state_dim: int, control_dim: int,
                node_c_dim: int = 0, node_g_dim: int = 0,
                edge_c_dim: int = 0, edge_g_dim: int = 0,
                theta_dim: int = 0) -> "Dimensions":
        """Reference: Dimensions::set_uniform (lqr.cpp:77-88)."""
        num_nodes = num_edges + 1
        return Dimensions(
            theta_dim=theta_dim,
            state_dims=(state_dim,) * num_nodes,
            control_dims=(control_dim,) * num_edges,
            node_c_dims=(node_c_dim,) * num_nodes,
            node_g_dims=(node_g_dim,) * num_nodes,
            edge_c_dims=(edge_c_dim,) * num_edges,
            edge_g_dims=(edge_g_dim,) * num_edges,
        )

    # --- max (padded) dims: these set the SoA array shapes -----------------
    @cached_property
    def max_state_dim(self) -> int:
        return max(self.state_dims, default=0)

    @cached_property
    def max_control_dim(self) -> int:
        return max(self.control_dims, default=0)

    @cached_property
    def max_node_c_dim(self) -> int:
        return max(self.node_c_dims, default=0)

    @cached_property
    def max_node_g_dim(self) -> int:
        return max(self.node_g_dims, default=0)

    @cached_property
    def max_edge_c_dim(self) -> int:
        return max(self.edge_c_dims, default=0)

    @cached_property
    def max_edge_g_dim(self) -> int:
        return max(self.edge_g_dims, default=0)

    @property
    def num_edges(self) -> int:
        return len(self.control_dims)

    @property
    def num_nodes(self) -> int:
        return len(self.state_dims)

    # --- aggregate dims of the flat interop layout -------------------------
    # (reference: lqr.cpp:146-180).  Only used for flat-vector interop /
    # parity against the C++ layout; solvers keep stagewise pytrees.
    @cached_property
    def stagewise_x_dim(self) -> int:
        result = self.state_dims[self.num_edges]
        for e in range(self.num_edges):
            result += self.state_dims[e] + self.control_dims[e]
        return result

    @cached_property
    def x_dim(self) -> int:
        return self.stagewise_x_dim + self.theta_dim

    @cached_property
    def y_dim(self) -> int:
        return (sum(self.state_dims) + sum(self.node_c_dims)
                + sum(self.edge_c_dims))

    @cached_property
    def z_dim(self) -> int:
        return sum(self.node_g_dims) + sum(self.edge_g_dims)

    @cached_property
    def stagewise_kkt_dim(self) -> int:
        return self.stagewise_x_dim + self.y_dim + self.z_dim

    @cached_property
    def is_uniform(self) -> bool:
        def _same(t):
            return len(set(t)) <= 1
        return all(_same(t) for t in (
            self.state_dims, self.control_dims, self.node_c_dims,
            self.node_g_dims, self.edge_c_dims, self.edge_g_dims))


def validate_input(dimensions: Dimensions,
                   topology: Topology) -> InputValidationStatus:
    """Validation mirroring the reference exactly
    (reference: sip_optimal_control/types.cpp:68-134): non-negative dims,
    root in range, no self loops, in-degree 1 for non-root / 0 for root,
    every node reaches the root."""
    num_edges = topology.num_edges
    num_nodes = topology.num_nodes
    if num_edges < 0 or dimensions.theta_dim < 0:
        return InputValidationStatus.INVALID_DIMENSIONS
    if (len(dimensions.state_dims) != num_nodes
            or len(dimensions.control_dims) != num_edges
            or len(dimensions.node_c_dims) != num_nodes
            or len(dimensions.node_g_dims) != num_nodes
            or len(dimensions.edge_c_dims) != num_edges
            or len(dimensions.edge_g_dims) != num_edges):
        return InputValidationStatus.INVALID_DIMENSIONS
    if any(d < 0 for d in (dimensions.state_dims + dimensions.node_c_dims
                           + dimensions.node_g_dims + dimensions.control_dims
                           + dimensions.edge_c_dims + dimensions.edge_g_dims)):
        return InputValidationStatus.INVALID_DIMENSIONS

    root = topology.root
    if root < 0 or root >= num_nodes:
        return InputValidationStatus.INVALID_TOPOLOGY
    parent_of = [-1] * num_nodes
    for parent, child in zip(topology.edge_parents, topology.edge_children):
        if (parent < 0 or parent >= num_nodes or child < 0
                or child >= num_nodes or parent == child):
            return InputValidationStatus.INVALID_TOPOLOGY
        if parent_of[child] != -1:
            return InputValidationStatus.INVALID_TOPOLOGY  # in-degree > 1
        parent_of[child] = parent
    if parent_of[root] != -1:
        return InputValidationStatus.INVALID_TOPOLOGY
    for node in range(num_nodes):
        if node != root and parent_of[node] == -1:
            return InputValidationStatus.INVALID_TOPOLOGY
        current = node
        for _ in range(num_nodes):
            if current == root:
                break
            current = parent_of[current]
        if current != root:
            return InputValidationStatus.INVALID_TOPOLOGY
    return InputValidationStatus.SUCCESS


@dataclasses.dataclass(frozen=True, eq=False)
class TopologySchedule:
    """Compiled traversal schedule.

    Replaces the reference's pointer-based CSR + DFS pre/postorder compile
    (reference: lqr.cpp:563-631) with static NumPy index arrays suitable for
    gather/scatter inside jit.  Adds a *level schedule* the reference doesn't
    have: nodes grouped by depth so that the tree Riccati recursion runs
    level-synchronously (O(depth) sequential steps, fully batched within a
    level) instead of node-by-node.
    """

    topology: Topology
    # CSR of children: child_offsets[node]..child_offsets[node+1] indexes
    # child_edges.
    child_offsets: np.ndarray          # [N+1] int32
    child_edges: np.ndarray            # [E] int32
    preorder: np.ndarray               # [N] int32 (root first)
    postorder: np.ndarray              # [N] int32 (leaves first)
    depth: np.ndarray                  # [N] int32, depth[root] == 0
    parent_edge: np.ndarray            # [N] int32, edge into node (-1 at root)
    parent_node: np.ndarray            # [N] int32 (-1 at root)
    # Level schedule: levels_nodes[d] = nodes at depth d; levels_edges[d] =
    # edges whose child is at depth d (d >= 1).
    levels_nodes: Tuple[np.ndarray, ...]
    levels_edges: Tuple[np.ndarray, ...]

    @property
    def num_levels(self) -> int:
        return len(self.levels_nodes)

    @property
    def max_level_width(self) -> int:
        return max(len(l) for l in self.levels_nodes)


def _schedule_from_arrays(topology: Topology, child_offsets, child_edges,
                          preorder, depth, parent_edge,
                          parent_node) -> TopologySchedule:
    """Assemble the schedule (postorder + level grouping) from the graph
    builder's raw index arrays — shared by the native (C++) and NumPy
    compilers."""
    num_nodes = topology.num_nodes
    postorder = preorder[::-1].copy()
    max_depth = int(depth.max()) if num_nodes else 0
    levels_nodes = tuple(
        np.nonzero(depth == d)[0].astype(np.int32)
        for d in range(max_depth + 1))
    levels_edges = tuple(
        np.asarray([parent_edge[n] for n in lvl], dtype=np.int32)
        for lvl in levels_nodes)
    return TopologySchedule(
        topology=topology, child_offsets=child_offsets,
        child_edges=child_edges, preorder=preorder, postorder=postorder,
        depth=depth, parent_edge=parent_edge, parent_node=parent_node,
        levels_nodes=levels_nodes, levels_edges=levels_edges)


def compile_topology(topology: Topology,
                     use_native: bool = True) -> TopologySchedule:
    """Host-side topology compile; raises TopologyError on invalid trees.

    Semantics match compile_topology_data (reference: lqr.cpp:563-631):
    children are visited in edge order; preorder via DFS; postorder is the
    reversed preorder.

    The graph-builder step runs in the native C++ runtime component
    (native/topology.cpp) when available, with this NumPy implementation as
    the semantically identical fallback (``use_native=False`` forces it;
    the tests assert agreement).
    """
    num_edges = topology.num_edges
    num_nodes = topology.num_nodes
    root = topology.root

    if use_native:
        from . import native as _native
        try:
            res = _native.compile_topology_native(
                num_edges, root, topology.edge_parents,
                topology.edge_children)
        except ValueError as err:
            raise TopologyError(str(err)) from None
        if res is not None:
            return _schedule_from_arrays(topology, *res)
    if root < 0 or root >= num_nodes:
        raise TopologyError(f"root {root} out of range [0, {num_nodes})")

    parents = np.asarray(topology.edge_parents, dtype=np.int32)
    children = np.asarray(topology.edge_children, dtype=np.int32)
    if num_edges and (
            (parents < 0).any() or (parents >= num_nodes).any()
            or (children < 0).any() or (children >= num_nodes).any()
            or (parents == children).any()):
        raise TopologyError("edge endpoints out of range or self-loop")

    child_offsets = np.zeros(num_nodes + 1, dtype=np.int32)
    for p in parents:
        child_offsets[p + 1] += 1
    child_offsets = np.cumsum(child_offsets).astype(np.int32)
    fill = child_offsets[:-1].copy()
    child_edges = np.zeros(num_edges, dtype=np.int32)
    for e in range(num_edges):
        p = parents[e]
        child_edges[fill[p]] = e
        fill[p] += 1

    parent_edge = np.full(num_nodes, -1, dtype=np.int32)
    parent_node = np.full(num_nodes, -1, dtype=np.int32)
    for e in range(num_edges):
        c = children[e]
        if parent_edge[c] != -1:
            raise TopologyError(f"node {c} has in-degree > 1")
        parent_edge[c] = e
        parent_node[c] = parents[e]
    if parent_edge[root] != -1:
        raise TopologyError("root has an incoming edge")

    # Iterative DFS matching the reference's stack order (children pushed in
    # reverse edge order so they pop in edge order).
    preorder = np.zeros(num_nodes, dtype=np.int32)
    depth = np.full(num_nodes, -1, dtype=np.int32)
    stack = [root]
    depth[root] = 0
    marks = np.zeros(num_nodes, dtype=bool)
    size = 0
    while stack:
        node = stack.pop()
        if size >= num_nodes or marks[node]:
            raise TopologyError("cycle detected")
        marks[node] = True
        preorder[size] = node
        size += 1
        for ci in range(child_offsets[node + 1] - 1, child_offsets[node] - 1,
                        -1):
            e = child_edges[ci]
            c = children[e]
            depth[c] = depth[node] + 1
            stack.append(int(c))
    if size != num_nodes:
        raise TopologyError("tree is disconnected")

    return _schedule_from_arrays(topology, child_offsets, child_edges,
                                 preorder, depth, parent_edge, parent_node)


def try_compile_topology(
        topology: Topology) -> Tuple[Optional[TopologySchedule], FactorStatus]:
    """Non-raising variant used where the reference returns INVALID_TOPOLOGY
    as a status (reference: lqr.cpp:640-643)."""
    try:
        return compile_topology(topology), FactorStatus.SUCCESS
    except TopologyError:
        return None, FactorStatus.INVALID_TOPOLOGY
