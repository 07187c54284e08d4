"""Post-training quantization: float weights -> W8A8 / W4A8 integer execution.

Port of ``repro.quant.ptq`` (``ptq_quantize_params``, the W4 policy,
``calibrate_ptq``'s group/clip search and ``quantized_param_fraction``), and
``quantize_for``, the launcher's choice of policy by precision.  Every GEMM
weight (attention wq/wk/wv/wo — cross-attention's and the whisper
encoder's too —, MLP w_in/w_gate/w_out — a MoE layer's
stacked experts and shared expert too, each expert with its own channel
scales and W4 groups fitted to the weight — Mamba-2 in_proj/out_proj — class
``attn``, as the reference's ``_CLASS_PATTERNS`` have it — the mLSTM's
wq/wk/wv/wo (class ``attn``) and w_gate/w_if (class ``mlp``), the sLSTM's
w_in (``mlp``) and wo (``attn``), and the ``unembed`` head) becomes
per-output-channel symmetric int8 ``{w_q, scale}``
or, where the policy says so, packed int4 ``{w4, qmul, scale}`` with
two-level group scales (int8 where no group fits K, or past ``W4_MAX_K``);
embeddings (a tied head with them), norms, the MoE
``router`` and ``shared_gate`` (the reference's ``_EXCLUDE``), the cross
layer's ``gate_attn``/``gate_mlp``, the encoder's ``pos_embed``, the
Mamba-2 conv and vectors, the sLSTM's ``r_w`` and the xLSTM norm scales stay
float, and so does the mLSTM's ``w_up``: no pattern of the reference's
``_QUANT_PATTERNS`` matches it, so it stays a bf16 linear inside an integer
model.  A shared block is one module, so
it is quantized once.  The reference runs PTQ eagerly, so
its divisions are true divisions here.  Bit-exact against the reference
(``tests/test_torch_models.py``; ``calibrate_ptq`` in
``tests/test_torch_no_cache.py``).
"""
from __future__ import annotations

import copy
import itertools

import torch

from ..kernels.int8_gemm import W4_MAX_K
from ..models.layers import Linear, quantize_weight, quantize_weight_w4
from ..models.lm import LM

# policy class of each quantizable weight, by module name
_CLASSES = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
            "in_proj": "attn", "out_proj": "attn",
            "w_in": "mlp", "w_gate": "mlp", "w_out": "mlp", "w_if": "mlp",
            "unembed": "head"}

# the reference's default W4A8 policy: projections in int4 at group 64, the
# lm head in int8 (it feeds the sampler; its bytes are small next to the MLP)
DEFAULT_W4_POLICY = {
    "attn": {"bits": 4, "group": 64, "clip": 1.0},
    "mlp": {"bits": 4, "group": 64, "clip": 1.0},
    "head": "int8",
}

W4_GROUPS = (32, 64, 128)
W4_CLIPS = (1.0, 0.9, 0.8)


def weight_class(name: str) -> str:
    """Quantization-policy class of a module path (``layers.3.mlp.w_in``):
    attn, mlp, head, or other."""
    return _CLASSES.get(name.rsplit(".", 1)[-1], "other")


def _fit_group(k: int, group: int) -> int | None:
    """Largest usable scale group <= the requested one that divides K (the
    packed container needs an even K as well); None demotes to int8.  Past
    ``W4_MAX_K`` too (yi-34b's down projection, K = 20480), where the
    reference's own PTQ packs the weight and its W4A8 GEMMs then refuse it
    (the int32 combine's headroom assert): the port keeps it int8
    (ROADMAP.md C14)."""
    if k % 2 or k > W4_MAX_K:
        return None
    for cand in [group] + [g for g in sorted(W4_GROUPS, reverse=True)
                           if g < group]:
        if k % cand == 0:
            return cand
    return None


@torch.no_grad()
def ptq_quantize_params(params: LM, policy: dict | None = None) -> LM:
    """Quantize the model's GEMM weights IN PLACE (each float weight is
    dropped as its payload is made, so peak memory stays near one model)
    and return the model.

    ``policy`` maps weight class -> "int8" | {"bits": 4, "group": g, "clip":
    c}; unlisted classes (and ``policy=None``) quantize to int8.  A w4 spec
    whose group cannot divide a weight's contraction dim demotes it to int8.
    """
    for name, mod in params.named_modules():
        cls = weight_class(name)
        if not isinstance(mod, Linear) or mod.quantized or cls == "other":
            continue
        spec = (policy or {}).get(cls, "int8")
        group = (_fit_group(mod.weight.shape[-2], int(spec["group"]))
                 if isinstance(spec, dict) else None)
        if group is None:
            mod.quantize_(quantize_weight(mod.weight))
        else:
            clip = float(spec.get("clip", 1.0))
            mod.quantize_(quantize_weight_w4(mod.weight, group=group,
                                             clip_ratio=clip))
    return params


def quantized_copy(params: LM, policy: dict | None = None) -> LM:
    """``ptq_quantize_params`` on a copy of the float model ``params``,
    which is left as it was: the copy shares every tensor it does not
    quantize (embeddings, norms, biases, and the float weights until each
    is replaced), so it costs one quantized model's memory."""
    memo = {id(t): t for t in itertools.chain(params.parameters(),
                                              params.buffers())}
    return ptq_quantize_params(copy.deepcopy(params, memo), policy)


@torch.no_grad()
def calibrate_ptq(params: LM, forward_logits, groups=W4_GROUPS,
                  clips=W4_CLIPS, classes=("attn", "mlp"),
                  max_rel_mse: float | None = None):
    """Greedy per-class W4 calibration search against a W8A8 quality proxy.

    ``forward_logits(quantized_model) -> logits`` must run the model on a
    FIXED calibration prompt set.  For each class (others int8), every
    (group, clip) candidate is scored by logit MSE against the all-int8
    forward; the per-class argmin wins.  With ``max_rel_mse``, a class
    whose best candidate exceeds ``max_rel_mse * mean(w8a8_logits^2)``
    falls back to int8.  Returns (policy, report): the policy feeds
    ``ptq_quantize_params`` and the report records every candidate's score.
    ``params`` (float) is left as it was; each candidate is quantized from
    it and freed before the next is built."""
    def logits(policy):
        return forward_logits(quantized_copy(params, policy)).float()

    base = logits(None)
    base_mag = float(torch.mean(base * base))
    policy, report = {"head": "int8"}, {}
    for cls in classes:
        scores = []
        for g in groups:
            for c in clips:
                lg = logits({cls: {"bits": 4, "group": g, "clip": c}})
                mse = float(torch.mean((lg - base) ** 2))
                del lg
                scores.append({"group": g, "clip": c, "mse": mse})
        best = min(scores, key=lambda s: s["mse"])
        demoted = (max_rel_mse is not None
                   and best["mse"] > max_rel_mse * base_mag)
        policy[cls] = "int8" if demoted else {
            "bits": 4, "group": best["group"], "clip": best["clip"]}
        report[cls] = {"best": best, "demoted_to_int8": demoted,
                       "scores": scores, "base_logit_msq": base_mag}
    return policy, report


def quantize_for(params: LM, precision: str) -> LM:
    """PTQ for a serving precision, as ``repro.launch.serve`` applies it:
    w4a8 by ``DEFAULT_W4_POLICY``, w8a8 every GEMM weight int8, bf16
    untouched.  ``params`` may be any module of the model (one block:
    ``models.lm.init_params`` quantizes the model a block at a time), since
    each weight's class comes from its own name."""
    if precision == "w4a8":
        return ptq_quantize_params(params, policy=DEFAULT_W4_POLICY)
    if precision == "w8a8":
        return ptq_quantize_params(params)
    if precision != "bf16":
        raise ValueError(f"unknown precision {precision!r}")
    return params


def quantized_param_fraction(params: LM) -> float:
    """Fraction of LOGICAL model parameters on an integer weight path,
    weighted by parameter count — of a float model (predictive) or a PTQ'd
    one (actual).  A packed int4 byte holds two logical weights; the scales
    and group multipliers of a quantized weight are metadata, not
    parameters."""
    q = tot = 0
    for name, mod in params.named_modules():
        if isinstance(mod, Linear) and weight_class(name) != "other":
            n = (2 * mod.w4.numel() if mod.int4 else
                 mod.w_q.numel() if mod.quantized else mod.weight.numel())
            q += n
            tot += n
    for name, p in params.named_parameters():
        if not name.endswith(".weight") or weight_class(name[:-7]) == "other":
            tot += p.numel()                  # embed, norms, qkv biases: float
    return q / max(tot, 1)
