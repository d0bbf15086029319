#!/usr/bin/env python3
"""When does ``torch.profiler`` lose the device records of its sessions?

    python3 chip_profiler_probe.py early 100 & \
    python3 chip_profiler_probe.py late 100 & \
    TEARDOWN_CUPTI=0 python3 chip_profiler_probe.py noteardown 100 & wait

Plain PyTorch only: nothing of the port runs. ``early`` opens a profiler
session at start, ``late`` first after 45 s; then each ticks every 8 s until
the given seconds. A tick runs three narrow sessions back to back (three
elementwise kernels, a drain after each, CUDA activity only) and prints the
device records each kept, then one session padded by 1 s of host sleep on
each side (CPU and CUDA activity) and the device records it kept with each
kernel's start minus its launch's start (us). Each kept trace should hold 3.
"""
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

T0 = time.perf_counter()


def session(x, pad, cpu):
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        time.sleep(pad)
        for op in (lambda: x.add_(1), lambda: x.mul_(2), lambda: x.sub_(1)):
            op()
            torch.cuda.synchronize()
        time.sleep(pad)
    ev = prof.events()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    launch = {e.id: e for e in ev
              if e.device_type == DeviceType.CPU and "Launch" in e.name}
    return len(dev), [round(e.time_range.start - launch[e.id].time_range.start)
                      for e in dev if e.id in launch]


def tick(x, mode):
    narrow = [session(x, 0.0, False)[0] for _ in range(3)]
    nw, ow = session(x, 1.0, True)
    print(f"{mode} t={time.perf_counter() - T0:6.1f}s narrow={narrow} "
          f"wide n={nw} off_us={ow}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_profiler_probe: no CUDA device")
    mode, total = sys.argv[1], float(sys.argv[2])
    x = torch.ones(1 << 20, device="cuda")
    if mode == "late":
        time.sleep(45)
    tick(x, mode)
    while time.perf_counter() - T0 < total:
        time.sleep(8)
        tick(x, mode)


if __name__ == "__main__":
    main()
