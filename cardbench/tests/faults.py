"""Faults planted under the timed path, for the tests that see ``correct``
come out false: the program broken underneath, the harness as it is."""
import os

import torch

FAULT_ENV = "CARDBENCH_TEST_FAULT"  # read by the ranks, which import afresh


def plant_decode(monkeypatch, name: str) -> None:
    """Break the decode step (``transformer.decode_step``) in this process."""
    from repro_torch.models import transformer as tf

    orig = tf.decode_step

    def state_unchanged(cfg, params, caches, batch, pos):
        copies = [{k: v.clone() for k, v in c.items()} for c in caches]
        return orig(cfg, params, copies, batch, pos)[0], caches

    def half_batch(cfg, params, caches, batch, pos):
        b = batch["tokens"].shape[0]
        h = b // 2
        half = [{k: v[:, :h] for k, v in c.items()} for c in caches]
        logits = orig(cfg, params, half, {"tokens": batch["tokens"][:h]}, pos)[0]
        rest = logits.mean(0, keepdim=True).expand(b - h, *logits.shape[1:])
        return torch.cat([logits, rest]), caches

    def answer_altered(cfg, params, caches, batch, pos):
        logits, caches = orig(cfg, params, caches, batch, pos)
        return logits.roll(1, -1), caches

    monkeypatch.setattr(tf, "decode_step", {"state_unchanged": state_unchanged,
                                            "half_batch": half_batch,
                                            "answer_altered": answer_altered}[name])


def plant_pipeline(name: str, microbatches: int) -> None:
    """Break the executor across ranks in this rank's process."""
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import pipeline_ranks as pr

    if name == "state_unchanged":  # a stage's Compute hands its input on unchanged
        tf.forward_layers = lambda cfg, stack, lo, hi, x: x
    elif name == "half_batch":  # the second half of each call's microbatches left out
        orig, count = tf.final_logits, [0]

        def final_logits(cfg, params, x):
            r, count[0] = count[0] % microbatches, count[0] + 1
            out = orig(cfg, params, x)
            return out if r < microbatches // 2 else torch.zeros_like(out)

        tf.final_logits = final_logits
    elif name == "exchange_left_out":  # no activation crosses a stage boundary
        put = pr._Messages.put
        pr._Messages.put = lambda self, b, h, r: put(self, b, torch.zeros_like(h), r)
    elif name == "answer_altered":  # one position of every microbatch's logits
        orig = tf.final_logits

        def altered(cfg, params, x):
            out = orig(cfg, params, x)
            out[:, 0] += 1.0
            return out

        tf.final_logits = altered
    else:
        raise ValueError(name)


def faulty_rank_body(rank, device, spec):
    from cardbench.drivers import pipeline_ranks

    plant_pipeline(os.environ[FAULT_ENV], spec["traffic"]["microbatches"])
    return pipeline_ranks.rank_body(rank, device, spec)
