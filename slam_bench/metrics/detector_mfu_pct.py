"""`detector_mfu_pct`: the detector's network's share of the H100's float32
peak: its operations per image at 640 x 640 (`yolox_flops.flops`, 26.69e9)
times the timed networks, over the device time the program's `detect.net`
span gives them, over 67 TFLOP/s, in percent.

That device time is the detector's stream's time between two CUDA events,
recorded before and after the host enqueues the network: it holds the
gaps where the stream waits for the host to launch the next kernel, and
time the kernels share the card with the tracker's, so it is at least the
network's kernel time, and the share is at most the kernels' own. A
change that launches the network faster, or runs fewer kernels beside it,
moves the share too. Nothing to read where the program has no `detect.net`
span or none of its networks was done when it was read."""

from slam_bench.yolox_flops import H100_FP32_FLOPS_PER_S, flops


def read(rec: dict):
    net = rec["spans"].get("detect.net")
    if not net or not net.get("count") or not net.get("device_ms", 0) > 0:
        return None
    per_s = flops() * net["count"] / (net["device_ms"] * 1e-3)
    return 100.0 * per_s / H100_FP32_FLOPS_PER_S
