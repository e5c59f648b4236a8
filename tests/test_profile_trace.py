"""The trace reducer of scripts/profile_trace.py, HLO side: the named
scope of each HLO instruction, looked up by the instruction's name and by
the name XLA gives its GPU kernel, and the category a scope counts under."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "scripts"))

import profile_trace as pt  # noqa: E402

_HLO = """HloModule m

%fused_computation.4 (p0: f32[4]) -> (f32[4], f32[4]) {
  %p0 = f32[4]{0} parameter(0)
  %add.1 = f32[4]{0} add(%p0, %p0), metadata={op_name="jit(f)/line_search/add"}
  %neg.2 = f32[4]{0} negate(%p0), metadata={op_name="jit(f)/model_eval/neg"}
  ROOT %t = (f32[4]{0}, f32[4]{0}) tuple(%add.1, %neg.2)
}

ENTRY %main.9 (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  %multiply.3 = f32[4]{0} multiply(%x, %x), metadata={op_name="jit(f)/newton_step/riccati/mul"}
  %loop_add_fusion.4 = (f32[4]{0}, f32[4]{0}) fusion(%multiply.3), kind=kLoop, calls=%fused_computation.4
  ROOT %gte = f32[4]{0} get-tuple-element(%loop_add_fusion.4), index=0
}
"""


def test_scopes_by_instruction_and_kernel_name():
    scopes = pt.hlo_scopes(_HLO)
    assert scopes["multiply.3"] == "jit(f)/newton_step/riccati/mul"
    assert scopes["multiply_3"] == scopes["multiply.3"]
    # a multi-output fusion joins the op_names of the computation it calls
    assert scopes["loop_add_fusion.4"] == ("jit(f)/line_search/add|"
                                           "jit(f)/model_eval/neg")
    assert scopes["loop_add_fusion_4"] == scopes["loop_add_fusion.4"]


def test_category_first_match_wins():
    scopes = pt.hlo_scopes(_HLO)
    assert pt.category("multiply_3", scopes["multiply_3"]) == "riccati"
    assert pt.category("loop_add_fusion_4",
                       scopes["loop_add_fusion_4"]) == "line_search"
    assert pt.category("chain_riccati_factor", "") == "riccati"
    assert pt.category("loop_copy_fusion", "jit(f)/copy") == "other"
