"""flash_roofline (%): the attention calls' least time on the chip over
the device time they took, in the traced stretch.

The calls are ``FlashAttention``'s forwards (recomputed ones included)
and backwards; each one's least time is the larger of its FLOPs over
the peak and its bytes over the memory bandwidth
(``pbench.flops.flash_call_work``, at its true lengths); its device time
is that of every kernel launched inside the call's span, the layout
copies and ``delta`` included."""
from pbench.flops import flash_call_work, roofline_s
from pbench.stats import call_lengths, elem_size

SPANS = {"flash": "repro_torch.kernels.flash_attention:FlashAttention"}


def read(run):
    t = run.trace
    if t is None or not t.tagged_s.get("flash"):
        return None
    cfg = run.cell.config
    bound = 0.0
    for c in t.calls:
        if c.tag != "flash" or len(c.args) < 3:
            continue
        (B, H, S, hd), dtype, _ = c.args[0]
        Hkv = c.args[1][0][1]
        lengths = call_lengths(c.args, 3, B, S)
        flops, nbytes = flash_call_work(H, Hkv, hd, elem_size(dtype), lengths,
                                        c.phase == "bwd")
        bound += roofline_s(flops, nbytes, float(cfg["peak_flops"]),
                            float(cfg["peak_bytes_per_s"]))
    return 100.0 * bound / t.tagged_s["flash"]
