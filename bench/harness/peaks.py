"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheets, SXM parts, dense rates).  A roofline share is stated against these
at the card's power limit, which every run prints beside it."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
DEFAULT = "NVIDIA H100 80GB HBM3"


def hbm_bytes_per_s(kind: str) -> float:
    """The memory rate of ``kind``; the H100 SXM's for a card not listed."""
    return PEAKS.get(kind, PEAKS[DEFAULT])["hbm_bytes_per_s"]
