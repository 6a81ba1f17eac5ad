"""The port's training over a pod group (A.10's multihost remainder)
held against the reference and against its own one-process step.

1. placement logic: the port's ``_device_grid`` / ``ici_violations``
   against the reference's on the same fake devices, over the
   reference's layouts and errors (``tests/test_multihost.py``), and
   the default-tp diagnostic;
2. ``init_distributed``'s env errors, with the reference's texts (the
   port names torch's ``MASTER_ADDR:MASTER_PORT`` where the reference
   names ``JAX_COORDINATOR_ADDRESS``);
3. two OS processes brought up from the Allocate-shaped group envs
   (``tests/torch_multihost_worker.py``, no JAX in them), training five
   forms over gloo: dp4 (DCN) x tp2 at the reference's layout (2 ranks
   x 4 devices), pp2 (DCN) x tp2, dp2 (DCN) x sp2 (zigzag ring), MoE
   dp2 (DCN) x ep2 and MoE pp2 (DCN) x ep2 (2 ranks x 2 devices): the
   ranks agree bit for bit, each form equals the one-process port step
   over the same global mesh bit for bit (losses and the whole state),
   and the dp x tp form tracks the reference's one-process dp4 x tp2
   run as the reference's own test holds it;
4. the payload as a rank pair: both ranks train and print the same
   final loss.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpushare import consts  # noqa: E402
from tpushare.workloads.parallel import multihost as jmh  # noqa: E402
from tpushare_torch import consts as tconsts  # noqa: E402
from tpushare_torch.workloads.parallel import multihost as tmh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_multihost_worker.py")


class FakeDev:
    def __init__(self, process_index: int, dev_id: int) -> None:
        self.process_index = process_index
        self.id = dev_id


def fakes(nproc: int, per: int) -> list:
    return [FakeDev(p, p * per + i) for p in range(nproc) for i in range(per)]


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)


def _procs(grid):
    return np.vectorize(lambda d: (d.process_index, d.id))(grid)


# (devices, dp, sp, tp, ep, pp, dcn_axis): tests/test_multihost.py's
LAYOUTS = {
    "dp-spans-hosts": (fakes(2, 4), 2, 2, 2, 1, 1, "dp"),
    "dp4-packs-low-bits": (fakes(2, 4), 4, 1, 2, 1, 1, "dp"),
    "pp-as-dcn": (fakes(2, 4), 2, 1, 2, 1, 2, "pp"),
    "dcn-not-a-multiple": (fakes(4, 2), 2, 1, 4, 1, 1, "dp"),
    "wrong-count": (fakes(2, 4), 2, 1, 2, 1, 1, "dp"),
    "dcn-tp": (fakes(2, 4), 2, 1, 4, 1, 1, "tp"),
    "uneven": ([FakeDev(0, 0), FakeDev(0, 1), FakeDev(1, 2)], 3, 1, 1, 1,
               1, "dp"),
    "ici-crossing": None,
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_device_grid_and_ici_violations_equal_the_references(case):
    if LAYOUTS[case] is None:
        # hand-built pathological grid: tp pairs one device of each host
        grid = np.array([FakeDev(0, 0), FakeDev(1, 2), FakeDev(0, 1),
                         FakeDev(1, 3)], dtype=object).reshape(2, 1, 2, 1, 1)
        for dcn in ("dp", "pp"):
            assert tmh.ici_violations(grid, dcn) == \
                jmh.ici_violations(grid, dcn) == ["tp"]
        return
    devs, *sizes, dcn = LAYOUTS[case]
    want = _outcome(jmh._device_grid, devs, *sizes, dcn)
    got = _outcome(tmh._device_grid, devs, *sizes, dcn)
    assert got[0] == want[0]
    if want[0] != "ok":
        assert got[1] == want[1]
        return
    np.testing.assert_array_equal(_procs(got[1]), _procs(want[1]))
    for axis in ("dp", "pp"):
        assert tmh.ici_violations(got[1], axis) == \
            jmh.ici_violations(want[1], axis)


def test_default_tp_diagnostic_is_the_references():
    want = _outcome(jmh.make_multihost_mesh, sp=4, devices=fakes(2, 2))
    got = _outcome(tmh.make_multihost_mesh, sp=4, devices=fakes(2, 2))
    assert got == want and "no tp in" in got[1]


GROUP_ENVS = (consts.ENV_GROUP_SIZE, consts.ENV_GROUP_RANK,
              consts.ENV_COORDINATOR, "JAX_COORDINATOR_ADDRESS",
              "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("env", [
    {consts.ENV_GROUP_SIZE: "two"},
    {consts.ENV_GROUP_SIZE: "2", consts.ENV_GROUP_RANK: "first"},
    {consts.ENV_GROUP_SIZE: "2", consts.ENV_GROUP_RANK: "0"},
    {consts.ENV_GROUP_SIZE: "2", consts.ENV_COORDINATOR: "127.0.0.1:1"},
    {consts.ENV_GROUP_SIZE: "1", consts.ENV_GROUP_RANK: "0"},
    {},
])
def test_init_distributed_env_errors_are_the_references(env, monkeypatch):
    for name in GROUP_ENVS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    want = _outcome(jmh.init_distributed)
    got = _outcome(tmh.init_distributed)
    assert got == (want[0], want[1].replace("JAX_COORDINATOR_ADDRESS",
                                            "MASTER_ADDR:MASTER_PORT")
                   if want[0] != "ok" else want[1])
    assert tconsts.ENV_GROUP_SIZE == consts.ENV_GROUP_SIZE


# ---- two real processes over gloo -----------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# gloo's TCP pairing races the kernel's port recycling (the probe socket
# closes before rank 0 binds it); only these signatures are retried, on
# a fresh port — tests/test_multihost.py's list
_GLOO_FLAKE_SIGNATURES = (
    "connectFullMesh", "Connection refused", "Connection reset by peer",
    "Address already in use", "address already in use", "Socket closed",
    "failed to connect", "Timed out waiting", "Connect timeout",
    "gloo::EnforceNotMet", "op.preamble",
)


def _run_rank_pair(argv: list[str], extra_env: dict | None = None,
                   attempts: int = 4, timeout: float = 300.0) -> list:
    """Both ranks with the Allocate-shaped group envs on a fresh
    coordinator port; the whole pair relaunched only when a rank dies
    with a gloo pairing signature. Returns [(stdout, stderr)] by rank,
    both exit codes asserted zero."""
    results = []
    for attempt in range(attempts):
        port = _free_port()
        procs = []
        for rank in range(2):
            env = dict(os.environ, **(extra_env or {}))
            for key in GROUP_ENVS:
                env.pop(key, None)
            env.update({consts.ENV_COORDINATOR: f"127.0.0.1:{port}",
                        consts.ENV_GROUP_SIZE: "2",
                        consts.ENV_GROUP_RANK: str(rank),
                        "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)})
            procs.append(subprocess.Popen(
                argv, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        results = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                results.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(rc == 0 for rc, _, _ in results):
            return [(out, err) for _, out, err in results]
        if attempt + 1 < attempts and any(
                rc != 0 and any(s in err for s in _GLOO_FLAKE_SIGNATURES)
                for rc, _, err in results):
            continue
        break
    for rc, _, err in results:
        assert rc == 0, f"rank failed:\n{err[-4000:]}"
    raise AssertionError("unreachable")  # pragma: no cover


def reference_dp4_tp2(tmp_path):
    """The reference's one-process dp4 x tp2 run of
    tests/test_multihost.py and its initial weights as a .npz."""
    import jax
    import jax.numpy as jnp
    from tpushare.workloads import train
    from tpushare.workloads.models.transformer import (TransformerConfig,
                                                       init_params)
    from tpushare.workloads.parallel.mesh import make_mesh, place_data

    import torch_multihost_worker as w
    cfg = TransformerConfig(**w.DENSE, dtype=jnp.float32)
    mesh = make_mesh(dp=4, tp=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    flat = {f"layers.{k}": np.asarray(v) for k, v in params["layers"].items()}
    flat.update({k: np.asarray(v) for k, v in params.items()
                 if k != "layers"})
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    opt = train.make_optimizer(lr=w.LR)
    state = train.place_state(train.init_state(params, opt), mesh)
    step = train.make_train_step(cfg, opt, mesh)
    tokens = w.tokens().astype(np.int32)
    inputs = place_data(np.ascontiguousarray(tokens[:, :-1]), mesh)
    targets = place_data(np.ascontiguousarray(tokens[:, 1:]), mesh)
    losses = []
    for _ in range(w.STEPS):
        state, loss = step(state, inputs, targets)
        losses.append(float(jax.device_get(loss)))
    nested = {"layers": {k.split(".", 1)[1]: v for k, v in flat.items()
                         if k.startswith("layers.")},
              **{k: v for k, v in flat.items() if "." not in k}}
    return path, nested, losses


def test_two_processes_equal_the_one_process_mesh(tmp_path):
    """init_from_env() from the group envs, the hybrid meshes, real
    steps with gathers and stage handoffs over gloo: bit for bit the
    one-process port step over the same global mesh."""
    import torch_multihost_worker as w
    path, ref_params, ref_losses = reference_dp4_tp2(tmp_path)
    pair = _run_rank_pair([sys.executable, str(WORKER)],
                          {"TPUSHARE_TEST_PARAMS": str(path)})
    by_rank = [{o["form"]: o for o in map(json.loads, out.splitlines())}
               for out, _ in pair]
    assert set(by_rank[0]) == set(w.FORMS)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for label in w.FORMS:
            r0, r1 = by_rank[0][label], by_rank[1][label]
            assert (r0["rank"], r1["rank"], r0["nproc"]) == (0, 1, 2)
            assert (r0["losses"], r0["digest"]) == \
                (r1["losses"], r1["digest"]), label
            one = w.run_form(label, ref_params if label == "dp4xtp2"
                             else None, multi=False)
            assert (r0["losses"], r0["digest"]) == \
                (one["losses"], one["digest"]), label
    finally:
        torch.set_num_threads(n)
    got = [float.fromhex(x) for x in by_rank[0]["dp4xtp2"]["losses"]]
    np.testing.assert_allclose(got, ref_losses, rtol=2e-4, atol=2e-5)


def test_train_payload_as_a_rank_pair():
    """``python -m tpushare_torch.workloads.train_payload`` under the
    group envs: the process group from init_from_env, the hybrid mesh
    over 2 x 4 CPU devices, each rank's own dp rows; both ranks print
    the same final loss."""
    pair = _run_rank_pair([
        sys.executable, "-m", "tpushare_torch.workloads.train_payload",
        "--device", "cpu", "--steps", "2", "--batch", "4", "--dp", "4",
        "--tp", "2", "--seq", "32"])
    finals = []
    for rank, (out, _) in enumerate(pair):
        assert f"distributed: rank {rank}/2" in out, out
        assert "on 8 cpu devices" in out, out
        finals.append(out.rsplit("final loss=", 1)[1].split()[0])
    assert finals[0] == finals[1], finals
