"""The vote kernel's share of its roofline, in percent: the bound of one
batch's vote (portbench/peaks.py: its [F, N, C] candidates read once and
its outputs written once, or its compare-and-selects, whichever takes
longer on an H100 at the data sheet's rates) times the vote launches in
the traced window, over their summed device time (torch.profiler)."""

from portbench.peaks import vote_bound_s


def read(rec):
    if rec.device is None:
        return None
    launches = rec.device.op_count("vote_")
    seconds = rec.device.op_seconds("vote_")
    if launches == 0 or seconds <= 0:
        return None
    o = rec.opts
    f = o.num_hash_functions * 2 * (2 if o.undirectional else 1)
    bound, _ = vote_bound_s(f, o.batchsize, o.probe_cap,
                            o.candidates_per_read_cap)
    return 100.0 * bound * launches / seconds
