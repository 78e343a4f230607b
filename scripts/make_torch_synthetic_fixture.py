"""Build the fixture that `chip_smoke.py` phase 11 holds the port's
synthetic renderer, run script, sharded solves and detector trainer to: the
JAX package's own runs on the CPU.

(a) Two rendered frames at 640x480 with tum_freiburg3()'s intrinsics,
    frame 7 of each scene of `dr_slam_torch._smoke.synthetic_scenes` (the
    default room among office clutter on the loop, and the small-room
    family of scripts/train_vocab.py), with quadratic depth noise from
    PRNGKey(7), quantised as the other fixtures are (uint8 gray, uint16
    depth units). The plain corridor is mapping_corridor.npz's.
(b) The summary JSON of the JAX scripts/run_synthetic.py --frames 24.
(c) Checksums of the JAX `synthetic_map_state` (240 keyframes, seed 3) at
    tests/test_backend.py's realistic capacity
    (`_smoke.map_state_cfg`): integer tables exactly, float tables as
    sums (`_smoke.state_checksums`).
(d) The JAX trainer (scripts/train_yolox.py) at init_params(0.33, 0.125):
    the loss of the first RandomState(7) batch of 8 and its gradient's
    global norm, and the losses of 20 steps of its loop (--steps 20).

Run from the repository root (a few minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_synthetic_fixture.py

Writes dr_slam_torch/data/synthetic_fixture.npz."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frames(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dr_slam_torch import _smoke
    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.io import synthetic

    cfg = tum_freiburg3()
    i = _smoke.SYNTH_FRAME
    for name, room, poses, boxes in _smoke.synthetic_scenes(synthetic):
        g, d = synthetic.render_frame(
            jnp.asarray(poses[i]), jnp.asarray(room.planes()),
            tuple(float(k) for k in cfg.camera.K4), 480, 640,
            depth_noise_key=jax.random.PRNGKey(i),
            boxes=jnp.asarray(boxes), quadratic_noise=True)
        out[f"{name}__gray"] = np.asarray(
            jnp.clip(g + 0.5, 0, 255).astype(jnp.uint8))
        out[f"{name}__depth"] = np.asarray(jnp.clip(
            d * cfg.camera.depth_factor + 0.5, 0, 65535).astype(jnp.uint16))


def run_summary(out: dict) -> None:
    from dr_slam_torch import _smoke

    run = _script("run_synthetic")
    with tempfile.TemporaryDirectory() as tmp:
        argv = sys.argv
        sys.argv = ["run_synthetic.py", "--frames",
                    str(_smoke.SYNTH_RUN_FRAMES), "--out", tmp]
        try:
            summary = run.main()
        finally:
            sys.argv = argv
    out["run_summary"] = json.dumps(summary)


def map_state(out: dict) -> None:
    import numpy as np

    from dr_slam_torch import _smoke
    from dr_slam_tpu import config
    from dr_slam_tpu.io.synthetic import synthetic_map_state

    st, poses = synthetic_map_state(_smoke.map_state_cfg(config),
                                    _smoke.MAP_KFS, seed=3)
    sums = _smoke.state_checksums({f: np.asarray(getattr(st, f))
                                   for f in st._fields})
    for name, v in sums.items():
        out[f"ms__{name}"] = v
    out["ms_poses_true"] = poses


def trainer(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from dr_slam_torch import _smoke

    tr = _script("train_yolox")
    steps, batch = _smoke.TRAIN_STEPS, _smoke.TRAIN_BATCH
    params = tr.yolox.init_params(0.33, 0.125)
    meta = params.pop("meta")
    params = jax.tree.map(jnp.asarray, params)
    # scripts/train_yolox.py's main, with every step's loss kept
    warm = min(50, max(steps // 10, 1))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=warm, decay_steps=max(steps, warm + 1))
    opt = optax.adam(sched)
    opt_state = opt.init(params)

    def lf(p, imgs, boxes, n_gts):
        return tr.loss_batch({**p, "meta": meta}, imgs, boxes, n_gts)

    @jax.jit
    def step(params, opt_state, imgs, boxes, n_gts):
        l, g = jax.value_and_grad(lf)(params, imgs, boxes, n_gts)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state, l, \
            optax.global_norm(g)

    rng = np.random.RandomState(7)
    losses = []
    for it in range(steps):
        imgs, boxes, n_gts = tr.make_batch(rng, batch)
        params, opt_state, l, gn = step(params, opt_state, jnp.asarray(imgs),
                                        jnp.asarray(boxes),
                                        jnp.asarray(n_gts))
        if it == 0:
            out["train_grad_norm0"] = np.float32(gn)
        losses.append(float(l))
    out["train_losses"] = np.asarray(losses, np.float32)
    out["train_rates"] = np.asarray([sched(c) for c in range(steps)],
                                    np.float32)


def main() -> None:
    import numpy as np

    from dr_slam_torch import _smoke

    out = {}
    frames(out)
    map_state(out)
    trainer(out)
    run_summary(out)
    np.savez_compressed(_smoke.SYNTH_FIXTURE, **out)
    print(f"wrote {_smoke.SYNTH_FIXTURE} "
          f"({os.path.getsize(_smoke.SYNTH_FIXTURE)} bytes): "
          f"{out['run_summary']}; losses {out['train_losses'].tolist()}")


if __name__ == "__main__":
    main()
