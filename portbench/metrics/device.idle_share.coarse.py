"""1 minus the union of each card's kernel, copy and set intervals over
the traced window, the mean over the cell's cards (torch.profiler)."""


def read(rec):
    if rec.device is None:
        return None
    dt = rec.device
    return sum(1.0 - dt.busy_s(c) / dt.window_s
               for c in rec.cards) / len(rec.cards)
