"""Roofline terms of the dry-run cells on H100s.

Port of ``repro.launch.roofline``.  ``active_params`` and ``model_flops``
are the reference's arithmetic on the config (MODEL_FLOPS = 6*N*D train,
2*N*D prefill, 2*N*B decode, N the parameters a token touches: an MoE
layer's routed top-k and shared experts only), equal to it with ``==``.
``roofline_row`` reads a record of ``launch/dryrun.py`` (a plan on the meta
device: no compiled program) and gives, per card and step:

  compute term  = model FLOPs / peak    (989 TFLOP/s bf16; 1979 TOP/s int8)
  memory term   = the rank's bytes of parameters, optimizer state, states
                  and inputs / 3.35 TB/s (each read once: a floor)

The reference's third term, collective bytes over the links, comes from
its compiled HLO (``hlo_analysis.py``), which the port has no counterpart
of; the port counts its collectives as it runs them (``dist.tp.COLLECTIVES``).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import SHAPES, get_config
from ..models.config import ArchConfig

PEAK_BF16 = 989e12        # FLOP/s a card, dense
PEAK_INT8 = 1979e12       # OP/s a card, dense
HBM_BW = 3.35e12          # B/s a card

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../experiments/dryrun_torch")


def active_params(cfg: ArchConfig) -> float:
    """Parameters touched per token (MoE: routed top-k + shared only)."""
    total = 0.0
    d = cfg.d_model
    # embeddings (lm head matmul; the input gather is negligible)
    total += cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    for kind in cfg.block_kinds:
        if kind in ("attn", "attn_swa", "enc", "shared_attn"):
            total += 2 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
            total += 3 * d * cfg.d_ff
        elif kind in ("moe", "moe_swa"):
            total += 2 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
            ff = cfg.moe_d_ff or cfg.d_ff
            total += 3 * d * ff * cfg.n_experts_per_tok
            total += 3 * d * ff * cfg.n_shared_experts
            total += d * cfg.n_experts  # router
        elif kind == "xattn":
            total += 2 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
            total += 3 * d * cfg.d_ff
        elif kind == "dec":
            total += 4 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
            total += 3 * d * cfg.d_ff
        elif kind == "mamba2":
            d_in = cfg.ssm_expand * d
            total += d * (2 * d_in + 2 * cfg.ssm_state) + d_in * d
        elif kind == "mlstm":
            d_up = 2 * d
            total += 2 * d * d_up + 3 * d_up * d_up + d_up * d
        elif kind == "slstm":
            total += 4 * d * d + d * d
    if cfg.is_encoder_decoder:
        # encoder layers (bidirectional attn + mlp)
        total += cfg.n_encoder_layers * (
            2 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
            + 3 * d * cfg.d_ff)
    return total


def model_flops(cfg: ArchConfig, shape: dict) -> float:
    """Matmul-parameter FLOPs for the cell, global (attention excluded)."""
    n = active_params(cfg)
    if shape["kind"] == "train":
        tokens = shape["seq_len"] * shape["global_batch"]
        return 6.0 * n * tokens
    if shape["kind"] == "prefill":
        tokens = shape["seq_len"] * shape["global_batch"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape["global_batch"]


_LEVERS = {
    "compute": ("raise arithmetic intensity: int8 (w8a8) execution doubles "
                "a card's peak; reduce remat recompute"),
    "memory": ("move fewer bytes: int8 KV cache, W4 weights, more rows a "
               "step to amortize weight reads"),
}


def load_cells(mesh: str = "16x16", precision: str = "bf16") -> list[dict]:
    """The dry-run records of ``mesh`` at ``precision``."""
    out = []
    for path in sorted(glob.glob(os.path.join(RESULTS_DIR, mesh, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("precision", "bf16") == precision:
            out.append(rec)
    return out


def roofline_row(rec: dict) -> dict:
    cfg = get_config(rec["arch"], precision=rec.get("precision", "bf16"))
    shape = SHAPES[rec["shape"]]
    peak = PEAK_INT8 if rec.get("precision") == "w8a8" else PEAK_BF16
    flops = model_flops(cfg, shape) / rec["n_devices"]
    moved = rec["bytes_per_device"]["total"]
    terms = {"compute": flops / peak, "memory": moved / HBM_BW}
    dominant = max(terms, key=terms.get)
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "dominant": dominant, "model_flops_per_device": flops,
        "bytes_per_device": moved, "fits": rec["fits"],
        "lever": _LEVERS[dominant],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    rows = [roofline_row(r) for r in load_cells(args.mesh, args.precision)]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    if args.json:
        print(json.dumps(rows, indent=1))
        return
    hdr = (f"| {'arch':22s} | {'shape':11s} | {'compute s':>10s} | "
           f"{'memory s':>10s} | {'bound':8s} | {'GiB/card':>8s} | fits |")
    print(hdr)
    print("|" + "-" * (len(hdr) - 2) + "|")
    for r in rows:
        print(f"| {r['arch']:22s} | {r['shape']:11s} | {r['compute_s']:10.4f} "
              f"| {r['memory_s']:10.4f} | {r['dominant']:8s} | "
              f"{r['bytes_per_device'] / 2 ** 30:8.2f} | "
              f"{'yes' if r['fits'] else 'no':4s} |")


if __name__ == "__main__":
    main()
