"""decode_tokens_per_s: tokens generated in the window, over the window."""


def read(record: dict):
    if "decode_tokens" not in record:
        return None
    return record["decode_tokens"] / record["window_s"]
