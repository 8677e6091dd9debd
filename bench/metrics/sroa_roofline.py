"""The fused SROA solve's share of its roofline, in percent, over the traced ticks: the
least time the work of its operands needs on this card (the larger of the
counted operations at the FP32 peak and the bytes read and written once at
the memory bandwidth) over the device time of every operation launched
inside the solve's span (``bench.k2``)."""


def read(run: dict):
    tr, work, peaks = run["trace"], run["work"], run["peaks"]
    if tr is None or work is None or peaks is None or not work["calls"]:
        return None
    device_s = tr["in_span"].get("k2", 0.0)
    if device_s <= 0.0:
        return None
    least = max(work["flops"] / peaks["fp32_flops_per_s"],
                work["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * least / device_s
