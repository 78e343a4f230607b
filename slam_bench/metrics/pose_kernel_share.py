"""`pose_kernel_share`: the share of the tracking step's pose solves that ran
as one launch of the program's pose kernel: the `pose_opt.kernel` spans
whose parent is `track.pose_opt` over the count of `track.pose_opt` spans in
the window. The kernel's launches for relocalization and loop refinement,
outside `track.pose_opt`, are not counted. The kernel has no fallback, so on
the card the share reads 1.0 wherever the step's solves engage it: an
engagement flag. Nothing to read where the program has either span missing
(a program whose solves have no kernel has no `pose_opt.kernel`) or does not
count a span's records by parent."""


def read(rec: dict):
    spans = rec["spans"]
    solves = spans.get("track.pose_opt", {}).get("count")
    kernel = spans.get("pose_opt.kernel", {}).get("parents")
    if not solves or kernel is None:
        return None
    return kernel.get("track.pose_opt", 0) / solves
