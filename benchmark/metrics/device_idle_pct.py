"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset runs on the card."""


def read(record):
    trace = record["trace"]
    if not trace or not trace["n_events"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
