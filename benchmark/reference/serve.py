"""The reference for served requests: one fp32 forward over each
sampled request's prompt and served tokens, from the seed's weights.

For each served token, the gap is how far its logit lies below the
reference's best logit at that position (0 when the reference would
have chosen it too); a request's reading is its widest gap. Greedy
serving may differ from the reference only where two logits lie within
rounding of each other, so the widest gap stays at that scale; a token
altered where it is produced, or a step that loses its cache, reads
several logits. The logprob gap is the widest distance between the
logprob the engine reported for a served token and the reference's
log-softmax at that token: a wrong normaliser or a shifted logprob
reads there even where the token is right.

With ``control=True`` the same forward also runs with every product's
operands rounded to fp8 (the control): its readings are the gap, under
the fp32 logits, of the token the fp8 forward puts first at each of
the same positions, and the distance between the fp8 forward's
logprob of that token and the reference's. Requests advance together
a layer at a time, so each layer's weights are made fp32 once."""

from __future__ import annotations

import torch

from benchmark.reference import transformer as T
from benchmark.weights import make_params


def served_gaps(seed: int, m: dict, requests: list[tuple[list, list, list]],
                device, control: bool = False,
                head_chunk: int = 8) -> list[dict]:
    """``requests``: (prompt ids, served ids, the served ids' logprobs
    as the engine reported them). Returns per request ``{"gap",
    "logprob_gap"}``, with control also ``"control_gap",
    "control_logprob_gap"``."""
    params = make_params(seed, m, m["dtype"], device)
    precs = {"fp32": T.exact, **({"fp8": T.fp8} if control else {})}
    seqs, hs = [], []
    for prompt, served, _ in requests:
        ids = torch.tensor(list(prompt) + list(served[:-1]),
                           dtype=torch.int64, device=device)
        seqs.append(ids)
        x = params["embed"][ids][None].float()
        hs.append({p: x for p in precs})
    out = []
    with torch.no_grad(), T.fp32_matmul():
        for i in range(m["n_layers"]):
            w = T.layer_weights(params, i)
            for ids, h in zip(seqs, hs):
                pos = torch.arange(ids.shape[0], device=device)
                for p, f in precs.items():
                    h[p] = T.layer(h[p], w, m, pos, f, head_chunk)
            del w
        nf, wout = params["norm_f"].float(), params["out"].float()
        for (prompt, served, logprobs), h in zip(requests, hs):
            first = len(prompt) - 1
            ref = T.head(h["fp32"][0, first:], nf, wout, m)
            served_t = torch.tensor(served, dtype=torch.int64, device=device)
            best = ref.max(dim=-1).values
            gap = best - ref.gather(-1, served_t[:, None])[:, 0]
            ref_lp = torch.log_softmax(ref, dim=-1)
            row = {"gap": float(gap.max()), "logprob_gap": float("inf")}
            if len(logprobs) == len(served):
                got = torch.tensor(logprobs, dtype=torch.float32,
                                   device=device)
                row["logprob_gap"] = float((got - ref_lp.gather(
                    -1, served_t[:, None])[:, 0]).abs().max())
            if control:
                ctl = T.head(h["fp8"][0, first:], nf, wout, m, T.fp8)
                pick = ctl.argmax(dim=-1)[:, None]
                cgap = best - ref.gather(-1, pick)[:, 0]
                ctl_lp = torch.log_softmax(ctl, dim=-1).gather(-1, pick)
                row["control_gap"] = float(cgap.max())
                row["control_logprob_gap"] = float(
                    (ctl_lp - ref_lp.gather(-1, pick)).abs().max())
            out.append(row)
    return out
