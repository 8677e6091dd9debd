"""Port parity: deadline-based straggler dropping
(``repro_torch.fed.straggler``) against ``repro.fed.straggler`` on the
same scenario and the same (assign, b, f, p): the per-user delays at rtol
1e-5, the same deadline, and the same participation masks round by
round."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import scenario_to_torch  # noqa: E402
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.fed import straggler as jst  # noqa: E402
from repro_torch.fed import straggler as tst  # noqa: E402

SPEC = dataclasses.replace(jw.ScenarioSpec(), N=12, M=3, D_range=(50, 90))
CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)


@pytest.fixture(scope="module")
def planned():
    scn = jw.draw_scenario(0, SPEC)
    assign = np.asarray(jw.nearest_edge_assignment(scn))
    res = jsroa.solve(scn, assign, 1.0, jsroa.SroaConfig(**CAPS))
    bfp = [np.asarray(x) for x in (res.b, res.f, res.p)]
    return scn, assign, bfp


def test_delays_deadline_and_masks_match_jax(planned):
    scn, assign, bfp = planned
    want = jst.per_user_delay(scn, assign, *bfp)
    got = tst.per_user_delay(scenario_to_torch(scn), assign,
                             *(torch.tensor(x) for x in bfp))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for q in (0.5, 0.9, 0.95):
        np.testing.assert_allclose(tst.over_provision_deadline(got, q),
                                   jst.over_provision_deadline(want, q),
                                   rtol=1e-5)
        assert tst.over_provision_deadline(want, q) \
            == jst.over_provision_deadline(want, q)
    deadline = jst.over_provision_deadline(want, 0.9)
    np.testing.assert_array_equal(tst.deadline_mask(got, deadline),
                                  jst.deadline_mask(want, deadline))
    jfn = jst.jittered_participation(want, deadline, seed=3)
    tfn = tst.jittered_participation(got, deadline, seed=3)
    for r in range(5):
        np.testing.assert_array_equal(tfn(r), jfn(r), err_msg=f"round {r}")


def test_participation_never_stalls_a_round():
    delays = np.array([5.0, 6.0, 7.0], np.float32)
    fn = tst.jittered_participation(delays, deadline=0.1, seed=0)
    for r in range(3):
        m = fn(r)
        assert m.sum() == 1.0 and m.dtype == np.float32
    ref = jst.jittered_participation(delays, deadline=0.1, seed=0)
    fn = tst.jittered_participation(delays, deadline=0.1, seed=0)
    for r in range(3):
        np.testing.assert_array_equal(fn(r), ref(r))
