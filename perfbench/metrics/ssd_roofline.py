"""ssd_roofline (%): the SSD scan calls' least time on the chip over the
device time they took, in the traced stretch.

The calls are ``SSDScan``'s forwards (recomputed ones included) and
backwards (today the plain chunked vjp); each one's least time is the
larger of its FLOPs over the peak and its bytes over the memory
bandwidth (``pbench.flops.ssd_call_work``, at its true lengths); its
device time is that of every kernel launched inside the call's span."""
from pbench.flops import roofline_s, ssd_call_work
from pbench.stats import call_lengths, elem_size

SPANS = {"ssd": "repro_torch.kernels.ssd_scan:SSDScan"}


def read(run):
    t = run.trace
    if t is None or not t.tagged_s.get("ssd"):
        return None
    cfg = run.cell.config
    bound = 0.0
    for c in t.calls:
        if c.tag != "ssd" or len(c.args) < 5:
            continue
        (B, S, _, _), dtype, _ = c.args[0]
        lengths = call_lengths(c.args, 5, B, S)
        flops, nbytes = ssd_call_work(run.cell.model, elem_size(dtype),
                                      lengths, c.phase == "bwd")
        bound += roofline_s(flops, nbytes, float(cfg["peak_flops"]),
                            float(cfg["peak_bytes_per_s"]))
    return 100.0 * bound / t.tagged_s["ssd"]
