"""The port's detector trainer (scripts/train_yolox_torch.py) against the
JAX trainer (scripts/train_yolox.py) on the CPU, at the trained model's
size (YOLOXNet at width 0.125, depth 0.33, 256x256).

Tolerances: the scenes bit for bit (numpy, RandomState(7)); the batch loss
at the JAX init within 1e-5 relative (observed equal), each parameter's
gradient within 1e-4 of the largest magnitude of JAX's gradient of that
parameter (observed 3.7e-6: the convolutions' float32 sums run in another
order); Adam under the schedule, fed the same gradients for 3 steps,
within 1e-5 of optax's parameters, and the schedule's rates equal to
optax's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dr_slam_tpu.models import yolox as jyolox
from dr_slam_torch.models import yolox as tyolox

from torch_parity import load_script

torch.set_num_threads(4)

J = load_script("train_yolox")
T = load_script("train_yolox_torch")
BATCH = 2


def test_make_batch_bit_equal():
    a = J.make_batch(np.random.RandomState(7), 3)
    b = T.make_batch(np.random.RandomState(7), 3)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_targets_equal():
    """The batched targets against the JAX trainer's per-image ones."""
    _, boxes, n_gts = T.make_batch(np.random.RandomState(3), 4)
    got = T.build_targets(torch.from_numpy(boxes), torch.from_numpy(n_gts))
    for b in range(4):
        want = J.build_targets(jnp.asarray(boxes[b]), jnp.asarray(n_gts[b]))
        for (to, tb), (jo, jb) in zip(got, want):
            np.testing.assert_array_equal(to[b].numpy(), np.asarray(jo))
            np.testing.assert_array_equal(tb[b].numpy(), np.asarray(jb))
    assert sum(float(o.sum()) for o, _ in got) > 0


def test_loss_and_gradients_at_jax_init():
    batch = T.make_batch(np.random.RandomState(7), BATCH)
    params = jyolox.init_params(0.33, 0.125)
    meta = params.pop("meta")
    params = jax.tree.map(jnp.asarray, params)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, *b: J.loss_batch({**p, "meta": meta}, *b)))(
            params, *map(jnp.asarray, batch))
    net, _ = T.make_net(0.33, 0.125, "cpu")
    lt = T.loss_batch(net, *T.to_device(batch, "cpu"))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    for name, g in gj.items():
        conv = net.convs[tyolox._key(name)]
        gw = np.transpose(conv.weight.grad.numpy(), (2, 3, 1, 0))
        for got, want in ((gw, np.asarray(g["w"])),
                          (conv.bias.grad.numpy(), np.asarray(g["b"]))):
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-4 * scale, name


def test_optimizer_matches_optax():
    """Three Adam steps under the 20-step schedule from the same seeded
    gradients: the first step's rate is 0, as optax's count-0 rate."""
    steps = 20
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(64, 3).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(3)]
    warm = T.warmup_steps(steps)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=warm, decay_steps=max(steps, warm + 1))
    for c in range(steps + 2):
        assert T.schedule_rate(c, 1e-3, warm, max(steps, warm + 1)) == \
            float(np.float32(sched(c))), c
    opt = optax.adam(sched)
    pj = jax.tree.map(jnp.asarray, p0)
    state = opt.init(pj)
    net = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(
        v.copy())) for k, v in p0.items()})
    topt, tsched = T.make_optimizer(net, steps, 1e-3)
    rates = []
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state)
        pj = optax.apply_updates(pj, upd)
        rates.append(topt.param_groups[0]["lr"])
        for k, v in g.items():
            net[k].grad = torch.from_numpy(v)
        topt.step()
        tsched.step()
    assert rates[0] == 0.0 and rates[1] > 0
    assert rates == [float(np.float32(sched(c))) for c in range(3)]
    moved = max(float(np.abs(np.asarray(pj[k]) - p0[k]).max()) for k in p0)
    assert moved > 1e-4
    for k in p0:
        np.testing.assert_allclose(net[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=0, atol=1e-5)


def test_saved_weights_load_in_both_packages(tmp_path):
    """A port-trained file (2 steps of batch 1 at width 0.125) read back by
    the JAX package's load_params and by the port's."""
    out = str(tmp_path / "y.npz")
    losses = T.main(["--steps", "2", "--batch", "1", "--out", out,
                     "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    jp = jyolox.load_params(out)
    tp = tyolox.load_params(out)
    net, meta = T.make_net(0.33, 0.125, "cpu")
    assert jp["meta"] == meta and tp["meta"] == meta
    assert set(jp) == set(tp) and len(jp) > 50
    for name in jp:
        if name == "meta":
            continue
        for wb in ("w", "b"):
            assert jp[name][wb].dtype == np.float32
            np.testing.assert_array_equal(jp[name][wb], tp[name][wb])
    # the saved HWIO weights are the trained module's, rounded to float16
    net2 = tyolox.YOLOXNet(tp["meta"])
    net2.load_state_dict(tyolox.params_to_state_dict(tp))
    init = tyolox.init_params(0.33, 0.125)
    assert any(np.abs(tp[k]["w"] - init[k]["w"]).max() > 1e-6
               for k in init if k != "meta")
    with torch.no_grad():
        y = net2(torch.zeros(1, 3, 64, 64))
    assert all(torch.isfinite(t).all() for lvl in y for t in lvl)


@pytest.mark.parametrize("steps", [1, 20, 700])
def test_warmup_matches_jax_script(steps):
    assert T.warmup_steps(steps) == min(50, max(steps // 10, 1))
