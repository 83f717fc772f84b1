"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit), and a kernel's least time for its work at them. A card
set below 700 W reaches less; every share is stated against these peaks,
with the card's power limit recorded beside the run."""

PEAK_BYTES_PER_S = 3.35e12   # HBM3
PEAK_BF16_FLOPS = 989e12     # bf16 tensor cores, dense
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores


def least_ms(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The larger of the bytes' and the operations' time at the peaks, ms."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops) * 1e3
