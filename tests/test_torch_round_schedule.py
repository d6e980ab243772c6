"""The port's round schedules (``repro_torch.comm.round_schedule``) vs the
JAX package's: rotation, greedy, BvN and the best of the three, part by
part, on tests/test_round_schedule.py's seeded cap battery of eight
ranks; each best schedule reaches the Birkhoff bound. Pure numpy on both
sides."""
import dataclasses

import pytest

from repro.comm import round_schedule as ref_rs
from repro_torch.comm import round_schedule as pt_rs
from test_round_schedule import _CASES, _birkhoff_T


def _assert_same_schedules(caps):
    for name in ("rotation_schedule", "greedy_schedule", "bvn_schedule",
                 "best_schedule"):
        ref, pt = getattr(ref_rs, name)(caps), getattr(pt_rs, name)(caps)
        assert pt.method == ref.method and pt.S == ref.S, name
        assert dataclasses.astuple(pt) == dataclasses.astuple(ref), name
        assert (pt.n_rounds, pt.wire_slots, pt.padding_slots()) == \
            (ref.n_rounds, ref.wire_slots, ref.padding_slots()), name


# the eight-rank cases here; tests/test_torch_mesh_plan.py takes the
# battery's meshes of 2, 3 and 5 ranks
CASES_S8 = [(n, c) for n, c in _CASES if c.shape[0] == 8]


@pytest.mark.parametrize("caps", [c for _, c in CASES_S8],
                         ids=[n for n, _ in CASES_S8])
def test_schedules_equal_reference_part_by_part(caps):
    """rotation / greedy / bvn / best: the same rounds, parts, slots and
    local parts as the reference's; best reaches the Birkhoff bound."""
    _assert_same_schedules(caps)
    best = pt_rs.best_schedule(caps)
    assert best.wire_slots == _birkhoff_T(caps)
    assert best.wire_slots <= pt_rs.rotation_schedule(caps).wire_slots
