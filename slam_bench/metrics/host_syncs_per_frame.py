"""`host_syncs_per_frame`: the times the host waited for the device inside
the program's spans per frame of the window: each span's `syncs` (the
implicit waits torch.cuda's sync debug mode reports and the explicit ones
counted at their sites, each in the innermost open span) summed over every
span, over the window's frames. Nothing to read where the program counts no
syncs."""


def read(rec: dict):
    spans = rec["spans"].values()
    if not rec["frames"] or not spans or any("syncs" not in s for s in spans):
        return None
    return sum(s["syncs"] for s in spans) / rec["frames"]
