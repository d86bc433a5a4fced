"""Prefill through the port's one-card entry point (``runtime/serve.py``
``make_prefill``, the full-sequence ``transformer.forward``), closed loop:
each call runs ``batch`` prompts of ``seq_len`` ids, uniform over the
vocabulary and new from the seed every call, and the next call begins when
the previous one's logits are on the card, as a prefill pool hands a batch on
and takes the next.

A dense configuration goes through ``drivers.arch_config``, its weights from
``weights.py`` and its reference ``reference/dense.py``; a hybrid one
(Zamba2 as published) through the port's ``HybridConfig`` of
``hybrid.port_fields`` (a port without that layout has none and refuses the
cell at once, before any weight is made),
``hybrid_weights.py`` and ``reference/zamba2.py``.

Set-up: the weights on the card from the seed, a pinned host buffer for the
checked logits, and one call, which builds the kernels and runs every shape
of the window. The window runs calls while ``--seconds`` have not passed and
ends when the last call begun inside it completes. Traced, ``trace_calls``
more calls run under the profiler after the window.

Checked once the window has closed and the program's weights are freed: the
logits of one call, drawn from the seed as a reservoir of one (each call
takes the place with chance 1 / (calls so far), so the call kept is uniform
over the window's), two of its sequences, one from each half of the batch,
at every position. They are copied to the host on a stream of their own
while the next call runs. The number compared is the largest distance of a
logit from the reference's, in units of the reference's RMS
(``logit_err``); and every call must launch the attention kernel once per
attention layer (``flash_launches_off``) and, in a hybrid, the SSD-scan
kernel once per mamba layer (``ssd_launches_off``): the launches of the
window minus those numbers times its calls, which must be 0.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from .. import compare, hybrid, hybrid_weights, span_trace, weights
from ..model_config import dims
from ..reference import dense, zamba2
from . import arch_config

SPANS = ("hybrid.mamba", "hybrid.shared")


def _model(cfg: dict) -> SimpleNamespace:
    """The cell's configuration as ``run`` uses it: the port's config,
    the weights, the reference and the kernel launches a call."""
    if hybrid.is_hybrid(cfg):
        # a port without the published layout has no HybridConfig: it fails
        # here, before any weight is made
        from repro_torch.configs.base import HybridConfig

        h = hybrid.hybrid_dims(cfg)

        def reference(seed, seq, dev, precisions):
            glob = {k: hybrid_weights.global_leaf(h, seed, k, dev)
                    for k in ("embed", "final_norm")}
            return zamba2.logits(h, lambda i: hybrid_weights.mamba_layer(h, seed, i, dev),
                                 lambda b: hybrid_weights.shared_block(h, seed, b, dev),
                                 lambda j: hybrid_weights.call(h, seed, j, dev), glob, seq,
                                 precisions=precisions)

        return SimpleNamespace(cfg=HybridConfig(**hybrid.port_fields(h)), vocab=h.vocab,
                               params=lambda seed, dev: hybrid_weights.model(h, seed, dev),
                               reference=reference, flash=h.calls, ssd=h.layers)
    d = dims(cfg)

    def reference(seed, seq, dev, precisions):
        glob = {k: weights.global_leaf(d, seed, k, dev) for k in ("embed", "final_norm",
                                                                   "lm_head")}
        return dense.logits(d, lambda i: weights.layer(d, seed, i, dev), glob, seq,
                            precisions=precisions)

    return SimpleNamespace(cfg=arch_config(cfg), vocab=d.vocab,
                           params=lambda seed, dev: weights.model(d, seed, dev),
                           reference=reference, flash=d.layers, ssd=0)


def run(spec: dict) -> list[dict]:
    from repro_torch.runtime.serve import make_prefill

    dev = torch.device(spec["device"], 0) if spec["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # initialises CUDA: the allocator's statistics need it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model = _model(spec["config"])
    prefill = make_prefill(model.cfg, dev)
    records = []
    for k, seed in enumerate(spec["seeds"]):
        t_seed = time.monotonic()
        rec = _run_seed(spec, model, prefill, dev, seed)
        rec["setup_s"] = rec.pop("t_start") - (spec["t0"] if k == 0 else t_seed)
        records.append(rec)
    return records


def _pick(seed: int, call: int, b: int) -> list[int]:
    """The sequences of ``call`` kept for the check: one of each half."""
    h = b // 2
    return [weights.mix(seed, "pick", "a", call) % h,
            h + weights.mix(seed, "pick", "b", call) % (b - h)]


def _replaces(seed: int, call: int) -> bool:
    """Whether ``call`` takes the reservoir's place: with chance 1 / (call + 1)."""
    return weights.mix(seed, "reservoir", call) % (call + 1) == 0


def _launches() -> tuple[int, int]:
    """The attention and SSD-scan kernels' launch counts so far."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd

    return fa.launches, ssd.launches


def _run_seed(spec: dict, model, prefill, dev: torch.device, seed: int) -> dict:
    cuda = dev.type == "cuda"
    tr, seconds = spec["traffic"], spec["seconds"]
    b, s = tr["batch"], tr["seq_len"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.params(seed, dev)
    kept = torch.empty((2, s, model.vocab), pin_memory=cuda)
    side = torch.cuda.Stream(dev) if cuda else None  # the kept logits' copy to the host

    def call(tag):
        """One call, returned once its logits are on the card."""
        logits = prefill(params, {"tokens": weights.tokens(seed, tag, (b, s), model.vocab, dev)})
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
        return logits

    call("warm-up")
    kept_call, call_s = None, []
    launches0 = _launches()
    t_start = last = time.monotonic()
    n = 0
    while last - t_start < seconds:
        logits = call(("call", n))
        if _replaces(seed, n):
            kept_call = n
            if cuda:  # the copy runs beside the next call
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for i, row in enumerate(_pick(seed, n, b)):
                        kept[i].copy_(logits[row], non_blocking=True)
                logits.record_stream(side)
            else:
                kept.copy_(logits[_pick(seed, n, b)])
        del logits
        now = time.monotonic()
        call_s.append(now - last)
        last, n = now, n + 1
    launches = [x1 - x0 for x0, x1 in zip(launches0, _launches())]
    if cuda:
        side.synchronize()
    rec = {"t_start": t_start, "window_s": last - t_start, "attempted": n * b, "failed": 0,
           "prefill_tokens": n * b * s, "calls": n, "call_s": call_s,
           "config": spec["config"], "traffic": tr, "chips": 1, "forbidden_modules": []}
    if spec["trace"]:
        done: list = []
        with span_trace.profiler(tr["trace_calls"], done, SPANS) as prof:
            for j in range(tr["trace_calls"] + 1):
                call(("trace", j))
                prof.step()
        rec["trace"] = {**done[0], "calls": tr["trace_calls"]}
    rec["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1,
                     "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    del params
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    seq = weights.tokens(seed, ("call", kept_call), (b, s), model.vocab, dev)[
        _pick(seed, kept_call, b)]
    precisions = ("fp32", "tf32") if spec["control"] else ("fp32",)
    ref = model.reference(seed, seq, dev, precisions)
    got = kept.to(dev)
    rec["checks"] = {"logit_err": {"value": compare.logit_err(got, ref["fp32"]),
                                   "limit": spec["limits"]["logit_err"]},
                     "flash_launches_off": {"value": abs(launches[0] - model.flash * n),
                                            "limit": 0}}
    if model.ssd:
        rec["checks"]["ssd_launches_off"] = {"value": abs(launches[1] - model.ssd * n),
                                             "limit": 0}
    if spec["control"]:
        rec["control"] = {"logit_err": compare.logit_err(ref["tf32"], ref["fp32"])}
    rec["reference_s"] = time.monotonic() - t_ref
    del ref, got, kept
    if cuda:
        torch.cuda.empty_cache()
    return rec
