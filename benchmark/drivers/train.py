"""A training cell: the port's ``train.make_train_step`` over one seeded
model, one batch a step.

Set-up builds the weights, the AdamW state and the step once, and
drives that same step through its first ``readings_steps`` steps with
the traffic's batches 0, 1, 2, ...: they warm up every kernel the
window runs and give the readings the reference checks (each step's
loss; the first gradient per leaf, from the first moment after one
step; each leaf's change after the steps the reference follows). The
window then runs the same step on the following batches until
``seconds`` have passed, synchronising after each step; its rate is
every step completed over the whole window. With tracing, the profiler
covers the window from the cell's ``trace.start_s`` to its end: a
profile of every step of a long window takes the profiler longer to
reduce than a run may last. Once the window has
closed and the peak memory is read, the program's state is freed and
the reference follows the first steps from the seed."""

from __future__ import annotations

import torch

from benchmark import checks
from benchmark.drivers.common import (free_device, launch_delta, launches,
                                      now, peak_bytes, port_config, sync)
from benchmark.reference.train import reference_train
from benchmark.weights import make_leaf, make_params, param_shapes


def program_grad_norms(state: dict, m: dict) -> dict[str, float]:
    """Per-leaf norm of the first gradient, from the first moment after
    one step: mu = (1 - b1) * g in the moment's dtype."""
    from tpushare_torch.workloads.train import B1
    mu = state["opt"]["mu"]
    c = torch.tensor(1 - B1, dtype=mu["embed"].dtype).item()
    out = {}
    for name in param_shapes(m):
        t = mu["layers"][name[7:]] if name.startswith("layers.") \
            else mu[name]
        if name.startswith("layers."):
            for i in range(t.shape[0]):
                out[f"{name}[{i}]"] = float(
                    torch.linalg.vector_norm(t[i].float())) / c
        else:
            out[name] = float(torch.linalg.vector_norm(t.float())) / c
    return out


def program_change_norms(seed: int, state: dict, m: dict,
                         device) -> dict[str, float]:
    params = state["params"]
    out = {}
    for name, shape in param_shapes(m).items():
        p0 = make_leaf(seed, name, shape, m["dtype"], device)
        p = params["layers"][name[7:]] if name.startswith("layers.") \
            else params[name]
        if name.startswith("layers."):
            for i in range(shape[0]):
                out[f"{name}[{i}]"] = float(torch.linalg.vector_norm(
                    p[i].float() - p0[i].float()))
        else:
            out[name] = float(torch.linalg.vector_norm(
                p.float() - p0.float()))
        del p0
    return out


def setup(ctx: dict):
    """Build the weights, the AdamW state and the step, and drive the
    step through the set-up steps. Returns (state, step, batch,
    readings); the step's next batch index is ``readings_steps``."""
    from tpushare_torch.workloads.train import (init_state, make_optimizer,
                                                make_train_step)
    cell, m, mix, seed = ctx["cell"], ctx["m"], ctx["mix"], ctx["seed"]
    device, gen = ctx["device"], ctx["traffic"]
    step_cfg = cell["step"]
    n_ref = int(cell["reference"]["steps"])
    n_read = int(step_cfg["readings_steps"])
    if n_read < n_ref:
        raise ValueError("the set-up steps must cover the reference's")
    cfg = port_config(m, int(mix["seq"]), remat=bool(step_cfg["remat"]))

    def batch(k):
        return gen.make_batch(mix, seed, k, m["vocab"], device)

    marks = {"start_s": now() - ctx.get("t_start", now())}
    params = make_params(seed, m, m["dtype"], device)
    sync(device)
    marks["weights_s"] = now() - ctx.get("t_start", now())
    opt = make_optimizer(**step_cfg["optimizer"])
    state = init_state(params, opt)
    step = make_train_step(cfg, opt, device=device)
    losses = []
    readings: dict = {}
    for k in range(n_read):
        state, loss = step(state, *batch(k))
        losses.append(loss)
        if k == 0:
            readings["grad_norms"] = program_grad_norms(state, m)
        if k + 1 == n_ref:
            readings["change_norms"] = program_change_norms(seed, state, m,
                                                            device)
    readings["losses"] = [float(x) for x in losses]
    sync(device)
    marks["first_steps_s"] = now() - ctx.get("t_start", now())
    readings["_setup_marks"] = marks
    return state, step, batch, readings


def reference(ctx: dict, batch, prec: str = "fp32",
              loss_mode: str = "mean") -> dict:
    cell = ctx["cell"]
    return reference_train(ctx["seed"], ctx["m"], batch,
                           int(cell["reference"]["steps"]),
                           cell["step"]["optimizer"], ctx["device"],
                           prec=prec, loss_mode=loss_mode)


def run(ctx: dict) -> dict:
    device, gen, mix = ctx["device"], ctx["traffic"], ctx["mix"]
    state, step, batch, readings = setup(ctx)
    sync(device)
    setup_s = now() - ctx["t_start"]

    before, _ = launches()
    tracer = ctx["tracer"]() if ctx["trace"] else None
    tr_start = float(ctx["cell"]["trace"]["start_s"])
    traced_from = None
    k, steps = int(ctx["cell"]["step"]["readings_steps"]), 0
    t0 = now()
    while True:
        if tracer is not None and traced_from is None and \
                now() - t0 >= tr_start:
            traced_from = launches()[0]
            tracer.__enter__()
        with torch.profiler.record_function("bench.train_step"):
            state, _ = step(state, *batch(k))
        k += 1
        steps += 1
        sync(device)
        window_s = now() - t0
        if window_s >= ctx["seconds"]:
            break
    traced_launches = None
    if traced_from is not None:
        tracer.__exit__(None, None, None)
        traced_launches = launch_delta(traced_from, launches()[0])
    after, fallbacks = launches()
    peak, reserved = peak_bytes(device)
    del state, step
    free_device(device)

    ref = reference(ctx, batch)
    numbers = checks.train_numbers(readings, ref)
    return {"kind": "train", "m": ctx["m"], "mix": mix, "setup_s": setup_s,
            "window_s": window_s, "steps": steps,
            "tokens_per_step": gen.tokens_per_step(mix),
            "attempted": steps, "failed": 0,
            "peak_bytes": peak, "reserved_bytes": reserved,
            "launches": launch_delta(before, after), "fallbacks": fallbacks,
            "trace": tracer.summary() if traced_from is not None else None,
            "trace_launches": traced_launches,
            "device": torch.device(device).type,
            "numbers": numbers, "program": readings, "reference": ref,
            "setup_marks": readings["_setup_marks"]}
