"""``make_optimizer`` against optax: adam with L2 decay, adamw, sgd.

The same seeded parameters and the same five seeded gradient sets (one of
them large enough to trigger the global-norm clip) go through the JAX
package's optax chain and the port's optimizer; parameters agree within 1e-6
after every step (float32; the port divides where optax multiplies by a
reciprocal in places).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import optax

from mia_tpu.training.state import make_optimizer as jax_optimizer

import torch

from mia_tpu_torch.schedule import poly_warmup_schedule
from mia_tpu_torch.training import ClippedAdam, ClippedSGD, make_optimizer

SHAPES = [(4, 3), (7,), (2, 3, 3, 2)]


def _trajectories(name, weight_decay, grad_clip=1.0, steps=5, lr=None):
    rng = np.random.default_rng(0)
    params0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * (10.0 if t == 2 else 0.1)).astype(np.float32)
              for s in SHAPES] for t in range(steps)]
    lr = lr or poly_warmup_schedule(1e-2, max_steps=20, warmup_steps=2)

    tx = jax_optimizer(name, lambda step: jnp.asarray([lr(int(s)) for s in range(steps + 1)])[step],
                       grad_clip=grad_clip, weight_decay=weight_decay)
    jp = [jnp.asarray(p) for p in params0]
    state = tx.init(jp)
    jax_traj = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        jax_traj.append([np.asarray(p) for p in jp])

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt = make_optimizer(name, tp, lr, grad_clip=grad_clip, weight_decay=weight_decay)
    torch_traj, norms = [], []
    for g in grads:
        norms.append(float(opt.step([torch.from_numpy(x) for x in g])))
        torch_traj.append([p.detach().numpy().copy() for p in tp])
    return jax_traj, torch_traj, norms, grads, opt


@pytest.mark.parametrize("name,weight_decay", [("adam", 0.1), ("adam", 0.0), ("adamw", 0.1),
                                               ("adamw", 0.0), ("sgd", 0.1), ("sgd", 0.0)])
def test_five_steps_match_optax(name, weight_decay):
    jax_traj, torch_traj, norms, grads, opt = _trajectories(name, weight_decay)
    for step, (want, got) in enumerate(zip(jax_traj, torch_traj)):
        for w, g in zip(want, got):
            assert np.abs(g - w).max() <= 1e-6, (name, step)
    # the returned norm is the pre-clip global norm; step 2 was clipped
    want_norm = [float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g))) for g in grads]
    np.testing.assert_allclose(norms, want_norm, rtol=1e-5)
    assert want_norm[2] > 1.0 > want_norm[0]
    assert opt.count == 5 and isinstance(opt, ClippedSGD if name == "sgd" else ClippedAdam)


def test_weight_decay_changes_the_trajectory_and_the_three_differ():
    finals = {}
    for name in ("adam", "adamw", "sgd"):
        with_decay = _trajectories(name, 0.1)[1][-1]
        without = _trajectories(name, 0.0)[1][-1]
        assert max(np.abs(a - b).max() for a, b in zip(with_decay, without)) > 1e-4, name
        finals[name] = with_decay
    assert np.abs(finals["adam"][0] - finals["adamw"][0]).max() > 1e-5
    assert np.abs(finals["adam"][0] - finals["sgd"][0]).max() > 1e-5


def test_no_clip_and_state_round_trip():
    jax_traj, torch_traj, *_ = _trajectories("sgd", 0.05, grad_clip=None)
    assert max(np.abs(a - b).max() for a, b in zip(jax_traj[-1], torch_traj[-1])) <= 1e-6
    for name in ("adamw", "sgd"):
        *_, opt = _trajectories(name, 0.1, steps=3)
        fresh = make_optimizer(name, [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES],
                               weight_decay=0.1)
        fresh.load_state_dict(opt.state_dict())
        assert fresh.count == 3 and len(fresh.nu) == (0 if name == "sgd" else len(SHAPES))
        assert all(torch.equal(a, b) for a, b in zip(fresh.mu, opt.mu))
    with pytest.raises(ValueError, match="not supported"):
        make_optimizer("lion", [torch.nn.Parameter(torch.zeros(2))])
