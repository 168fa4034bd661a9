"""The port's graft entry points (``gsorb_slam_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py``, on the CPU.

- ``entry(device="cpu")``: the same scene tensors (the same seeded draws);
  its ``(loss, color)`` within 1e-3 relative and 2e-3 absolute of the JAX
  ``entry()`` fn's (jitted); two calls bitwise equal; a backward with
  finite gradients.
- ``dryrun_multichip(2, device="cpu")``: two gloo ranks, finite losses and
  pose, the ranks bitwise equal, one mapping ``all_reduce`` and one per
  tracking iteration, no rank imported JAX; eight ranks as well (marked
  slow, as the JAX package's is); on the card it raises when there are
  fewer cards than ranks.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jge
from gsorb_slam_tpu_torch import graft_entry as ge

torch.set_num_threads(1)


def test_entry_matches_jax():
    fn, args = ge.entry(device="cpu")
    jfn, jargs = jge.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert args[0].shape == (32768, 3)
    assert int(ge._scene(device="cpu")[1]["active"].sum()) == 20000
    with torch.no_grad():
        loss, color = fn(*args)
        loss2, color2 = fn(*args)
    jloss, jcolor = jax.jit(jfn)(*jargs)
    assert color.shape == (240, 320, 3)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)
    np.testing.assert_allclose(color.numpy(), np.asarray(jcolor), rtol=0, atol=2e-3)
    assert torch.equal(loss, loss2) and torch.equal(color, color2)
    params = [a.clone().requires_grad_(True) for a in args]
    fn(*params)[0].backward()
    for p in params:
        assert p.grad is not None and torch.isfinite(p.grad).all()
    assert float(params[0].grad.abs().sum()) > 0


def _check_dryrun(results, n):
    assert len(results) == n
    r0 = results[0]
    assert np.isfinite(r0["loss"]) and np.isfinite(r0["track_loss"])
    assert np.isfinite(r0["T_cw"]).all()
    assert r0["collectives"]["all_reduce"] == 1 + 3  # the mapping step, 3 tracking iterations
    for r in results:
        assert not r["jax_imported"]
        assert r["loss"] == r0["loss"] and r["track_loss"] == r0["track_loss"]
        np.testing.assert_array_equal(r["T_cw"], r0["T_cw"])
        assert r["collectives"] == r0["collectives"]


def test_dryrun_multichip_2_cpu():
    _check_dryrun(ge.dryrun_multichip(2, device="cpu"), 2)


@pytest.mark.slow
def test_dryrun_multichip_8_cpu():
    _check_dryrun(ge.dryrun_multichip(8, device="cpu"), 8)


def test_dryrun_multichip_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="device_count"):
        ge.dryrun_multichip(2)
