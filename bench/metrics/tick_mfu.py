"""The traced ticks' share of the card's FP32 peak, in percent: the operations every
SROA problem of those ticks needs (counted as for ``sroa_roofline``) over
the ticks' length on the trace's clock and the peak."""


def read(run: dict):
    tr, work, peaks = run["trace"], run["work"], run["peaks"]
    if tr is None or work is None or peaks is None or not work["calls"]:
        return None
    if tr["window_s"] <= 0.0:
        return None
    return (100.0 * work["flops"] / tr["window_s"]
            / peaks["fp32_flops_per_s"])
