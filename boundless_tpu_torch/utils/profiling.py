"""Per-kernel timing + roofline accounting.

The port's counterpart of `boundless_tpu/utils/profiling.py`: `profile_fn`
times a function (one warm-up, then `reps` runs, the card synchronized
before each clock read); `roofline` reports the achieved fraction of the
card's peaks for a declared operation/byte budget. The peaks are the
H100's: HBM3 at 3.35 TB/s (NVIDIA data sheet, H100 SXM), and the 32-bit
integer issue rate read from the card itself (SMs x 128 instructions per
clock x the maximum SM clock, as `chip_smoke.py` takes it).
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
import time

import torch

H100_HBM3_GBPS = 3350.0  # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer instructions one sm_90 SM issues per clock: four
# schedulers, one warp instruction each (H100 whitepaper)
ISSUE_PER_CLOCK_PER_SM = 128


@functools.lru_cache(maxsize=None)
def int32_peak_tops(device: int = 0) -> float:
    """The card's 32-bit integer issue rate in tera-operations per second:
    SMs x ISSUE_PER_CLOCK_PER_SM x the maximum SM clock (nvidia-smi)."""
    mhz = subprocess.run(
        ["nvidia-smi", f"--id={device}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * ISSUE_PER_CLOCK_PER_SM * float(mhz) * 1e6 / 1e12


@dataclasses.dataclass
class KernelProfile:
    name: str
    seconds: float
    flops: float = 0.0  # operations of the declared budget
    bytes_accessed: float = 0.0

    @property
    def achieved_tflops(self):
        return self.flops / self.seconds / 1e12 if self.seconds else 0.0

    @property
    def achieved_gbps(self):
        return self.bytes_accessed / self.seconds / 1e9 if self.seconds else 0.0

    def roofline(self, peak_tflops=None, hbm_gbps=H100_HBM3_GBPS) -> dict:
        """Fractions of the peaks; `peak_tflops` defaults to the card's
        int32 issue rate (`int32_peak_tops`)."""
        peak = int32_peak_tops() if peak_tflops is None else peak_tflops
        return dict(
            name=self.name,
            seconds=self.seconds,
            achieved_tflops=self.achieved_tflops,
            compute_fraction=self.achieved_tflops / peak,
            achieved_gbps=self.achieved_gbps,
            bandwidth_fraction=self.achieved_gbps / hbm_gbps,
            bound=("bandwidth" if self.achieved_gbps / hbm_gbps
                   > self.achieved_tflops / peak else "compute"),
        )


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_fn(name, fn, *args, reps=5, flops=0.0, bytes_accessed=0.0,
               **kwargs) -> KernelProfile:
    """Time a function: one warmup, then `reps` timed runs."""
    fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kwargs)
    _sync()
    return KernelProfile(name=name, seconds=(time.perf_counter() - t0) / reps,
                         flops=flops, bytes_accessed=bytes_accessed)
