"""prefill_tokens_per_s: prompt tokens whose logits the timed path produced,
over the window (which ends when the last call begun inside it completes)."""


def read(record: dict):
    if "prefill_tokens" not in record:
        return None
    return record["prefill_tokens"] / record["window_s"]
