"""Summed device milliseconds of every kernel, copy and set in the traced
window, over all the cell's cards, per million reads mapped in it
(torch.profiler)."""


def read(rec):
    if rec.device is None or not rec.device.ops:
        return None
    return rec.device.op_seconds() * 1e3 / (rec.reads / 1e6)
