"""Configuration files (``configs/<name>.json``, published keys as in
the model's ``config.json``) mapped onto the sizes the harness, the
reference and the port share. Nothing here imports the port: the
driver builds the port's ``TransformerConfig`` from :func:`dims`."""

from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
# the port's rmsnorm has no eps field: it always uses this value
PORT_RMS_EPS = 1e-6
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def load_config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    with open(path) as f:
        cfg = json.load(f)
    if cfg.get("name") != name:
        raise ValueError(f"{path} names itself {cfg.get('name')!r}")
    return cfg


def dims(cfg: dict) -> dict:
    """The sizes of a dense RMSNorm / RoPE / SwiGLU decoder with an
    untied head, from a config file's published keys. Refuses what the
    port's transformer cannot run as published."""
    if cfg.get("hidden_act") != "silu":
        raise ValueError(f"hidden_act {cfg.get('hidden_act')!r}: the port "
                         "runs SwiGLU (silu) only")
    if cfg.get("tie_word_embeddings"):
        raise ValueError("tied embeddings: the port's head is untied")
    if cfg.get("rope_scaling") or cfg.get("sliding_window"):
        raise ValueError("rope scaling or a sliding window is not run as "
                         "published by the port")
    # the one departure from a published value: the port's rmsnorm
    # runs PORT_RMS_EPS whatever the config says, so the sizes the
    # harness and the reference use say so too; the config file keeps
    # the published value and names the departure
    listed = {d["key"] for d in cfg.get("departures", [])}
    if float(cfg["rms_norm_eps"]) != PORT_RMS_EPS and \
            "rms_norm_eps" not in listed:
        raise ValueError(f"rms_norm_eps {cfg['rms_norm_eps']}: the port "
                         f"runs {PORT_RMS_EPS}; list the departure")
    D, H = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    hd = int(cfg.get("head_dim") or D // H)
    if hd * H != D:
        raise ValueError(f"head_dim {hd} x {H} heads != hidden {D}")
    return {"vocab": int(cfg["vocab_size"]), "d_model": D, "n_heads": H,
            "kv_heads": int(cfg.get("num_key_value_heads") or H),
            "head_dim": hd, "n_layers": int(cfg["num_hidden_layers"]),
            "d_ff": int(cfg["intermediate_size"]),
            "rope_theta": float(cfg["rope_theta"]),
            "rms_eps": PORT_RMS_EPS,
            "dtype": DTYPES[cfg["torch_dtype"]]}


def param_count(m: dict) -> int:
    D, F, V, L = m["d_model"], m["d_ff"], m["vocab"], m["n_layers"]
    KD = m["kv_heads"] * m["head_dim"]
    return V * D + L * (2 * D * D + 2 * D * KD + 3 * D * F + 2 * D) \
        + D + D * V
