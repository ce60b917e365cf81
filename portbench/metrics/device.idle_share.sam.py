"""1 minus the union of the card's kernel, copy and set intervals over
the traced window (torch.profiler)."""


def read(rec):
    if rec.device is None:
        return None
    return 1.0 - rec.device.busy_s(rec.cards[0]) / rec.device.window_s
