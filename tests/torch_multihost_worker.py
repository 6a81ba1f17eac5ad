"""Rank body of the port's two-process training test.

Not collected by pytest: ``tests/test_torch_multihost.py`` spawns it once
per rank with the Allocate-shaped group envs (``TPUSHARE_GROUP_RANK`` /
``_SIZE`` / ``TPUSHARE_COORDINATOR``), and imports :func:`run_form` to
run the one-process port step over the same global meshes. It imports
neither ``jax`` nor anything of ``tpushare``: the reference's initial
weights for the dp x tp form arrive as a ``.npz`` file
(``TPUSHARE_TEST_PARAMS``). Prints one JSON line per form: the losses
(``float.hex``) and a digest of the whole state after the steps.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpushare_torch.workloads import bridge, train  # noqa: E402
from tpushare_torch.workloads.models import moe as tm  # noqa: E402
from tpushare_torch.workloads.models import transformer as tt  # noqa: E402
from tpushare_torch.workloads.parallel import multihost  # noqa: E402
from tpushare_torch.workloads.parallel import pipeline  # noqa: E402
from tpushare_torch.workloads.parallel.mesh import make_mesh  # noqa: E402

LR = 1e-2
STEPS = 2
B, S = 4, 32
DENSE = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=S)
MOE = dict(DENSE, d_ff=64, n_experts=4, expert_top_k=2)

# label: (global mesh, DCN axis, devices a rank names, kind)
FORMS = {
    "dp4xtp2": (dict(dp=4, tp=2), "dp", 4, "dense"),
    "pp2xtp2": (dict(dp=1, tp=2, pp=2), "pp", 2, "pp"),
    "dp2xsp2": (dict(dp=2, sp=2, tp=1), "dp", 2, "ring"),
    "moe-dp2xep2": (dict(dp=2, ep=2, tp=1), "dp", 2, "moe"),
    "moe-pp2xep2": (dict(dp=1, ep=2, tp=1, pp=2), "pp", 2, "moe-pp"),
}


def tokens() -> np.ndarray:
    """The reference test's batch: (4, 33) ints from seed 7."""
    rng = np.random.default_rng(7)
    return rng.integers(0, DENSE["vocab"], (B, S + 1)).astype(np.int64)


def digest(state: dict) -> str:
    """sha256 over every whole tensor of the gathered state."""
    h = hashlib.sha256()
    for t in train.tree_leaves({k: v for k, v in
                                train.gather_state(state).items()
                                if k != "step"}):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_form(label: str, ref_params: dict | None = None,
             multi: bool = True) -> dict:
    """``label``'s 2 steps: over the group's hybrid mesh (``multi``,
    this process's rows through ``shard_host_batch``) or over the one
    -process mesh of the same global shape."""
    mesh_kw, dcn, per, kind = FORMS[label]
    moe = kind.startswith("moe")
    cfg = (tm.MoEConfig(**MOE, dtype=torch.float32) if moe else
           tt.TransformerConfig(**DENSE, dtype=torch.float32))
    if multi:
        mesh = multihost.make_multihost_mesh(**mesh_kw, dcn_axis=dcn,
                                             devices=["cpu"] * per)
    else:
        n = int(np.prod(list(mesh_kw.values())))
        mesh = make_mesh(devices=["cpu"] * n, **mesh_kw)
    if ref_params is not None:
        params = bridge.params_from_numpy(ref_params, device="cpu")
    elif moe:
        params = tm.init_moe_params(torch.Generator().manual_seed(3), cfg,
                                    "cpu")
    else:
        params = tt.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    opt = train.make_optimizer(lr=LR, clip_norm=1.0 if kind == "pp"
                               else None)
    state = train.init_state(params, opt)
    if kind == "pp":
        state = pipeline.place_pp_state(state, mesh)
        step = pipeline.make_pp_train_step(cfg, opt, mesh, n_micro=2)
    elif kind == "moe-pp":
        state = pipeline.place_moe_pp_state(state, mesh)
        step = pipeline.make_moe_pp_train_step(cfg, opt, mesh, n_micro=2)
    elif kind == "moe":
        state = train.place_moe_state(state, mesh)
        step = train.make_moe_train_step(cfg, opt, mesh)
    else:
        state = train.place_state(state, mesh)
        step = train.make_train_step(cfg, opt, mesh,
                                     ring_attention=kind == "ring")
    tok = torch.from_numpy(tokens())
    inputs, targets = tok[:, :-1], tok[:, 1:]
    if multi:
        rank, nproc = multihost.process_index(), multihost.process_count()
        rows = (slice(rank * B // nproc, (rank + 1) * B // nproc)
                if dcn == "dp" else slice(None))
        inputs = multihost.shard_host_batch(inputs[rows], mesh)
        targets = multihost.shard_host_batch(targets[rows], mesh)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, inputs, targets)
        losses.append(float(loss))
    return {"form": label, "losses": [x.hex() for x in losses],
            "digest": digest(state)}


def main() -> None:
    torch.set_num_threads(1)
    assert multihost.init_from_env(), "TPUSHARE_* group envs missing"
    ref = dict(np.load(os.environ["TPUSHARE_TEST_PARAMS"]))
    nested: dict = {"layers": {}}
    for key, value in ref.items():
        if key.startswith("layers."):
            nested["layers"][key.split(".", 1)[1]] = value
        else:
            nested[key] = value
    for label in FORMS:
        out = run_form(label, nested if label == "dp4xtp2" else None)
        out.update(rank=multihost.process_index(),
                   nproc=multihost.process_count())
        print(json.dumps(out), flush=True)
    assert "jax" not in sys.modules and not any(
        m == "tpushare" or m.startswith("tpushare.") for m in sys.modules)


if __name__ == "__main__":
    main()
