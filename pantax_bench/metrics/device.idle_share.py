"""device.idle_share: the share of the traced window in which no kernel,
copy or memset ran on the card, in %: 100 (1 - busy / window), from the
torch.profiler trace (CUDA activity only)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
