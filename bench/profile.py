"""A profiled slice of the served loop: the device's operations, its busy
time, and what the host did while the card idled.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Tuple

import torch

# copied from chip_smoke.py: host calls whose work the card records; each
# must find its device record, by correlation id, in a whole trace
ISSUED = re.compile(r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy)")
PROFILE_ATTEMPTS = 5
PROFILE_PAD = 128


# copied from chip_smoke.py::kernel_name
def kernel_name(name: str) -> str:
    """``void gla_scan_state_prefix_kernel<64>(float*, ...)`` ->
    ``gla_scan_state_prefix_kernel``."""
    m = re.search(r"(\w+)(?:<[^(]*>)?\(", name)
    return m.group(1) if m else name[:40]


# copied from chip_smoke.py::profiled; returns the host events too and
# counts its attempts
def profiled(fn, what: str, whole=lambda device: True):
    """(device events, host events, traced wall ms, attempts) of one call of
    ``fn`` and the card's drain in a ``torch.profiler`` session (CPU and
    CUDA activity), or None. The profiler has been seen to lose device
    records of its sessions from 10-20 s after a process's first session
    on (the first records of a session, or its last). So ``fn`` runs
    between ``PROFILE_PAD`` launches of ``torch.cuda._sleep``'s
    ``spin_kernel`` before it and as many after it (left out of what this
    returns), and a trace counts only when every kernel launch and copy that
    ``fn`` issued has its device record and ``whole(device)`` holds. It is
    taken again otherwise, up to ``PROFILE_ATTEMPTS`` sessions; when none is
    whole this prints what the last one lost and returns None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = prof.events()
        host = [e for e in events if e.device_type == DeviceType.CPU]
        issued = sorted((e for e in host if ISSUED.match(e.name)),
                        key=lambda e: e.time_range.start)
        pad_ids = {e.id for e in issued[:PROFILE_PAD] + issued[-PROFILE_PAD:]}
        issued = issued[PROFILE_PAD:-PROFILE_PAD]
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        pad = [e for e in device if "spin_kernel" in e.name]
        device = [e for e in device if "spin_kernel" not in e.name]
        seen = {e.id for e in device}
        lost = [i for i, e in enumerate(issued) if e.id not in seen]
        apart = (all(e.id in pad_ids for e in pad)
                 and not any(e.id in pad_ids for e in device))
        if device and apart and not lost and whole(device):
            print(f"profiled slice ({what}): trace {attempt} of "
                  f"{PROFILE_ATTEMPTS} whole")
            return device, host, wall, attempt
    names = {}
    for e in device:
        names[kernel_name(e.name)] = names.get(kernel_name(e.name), 0) + 1
    print(f"profiled slice ({what}): not measured: none of {PROFILE_ATTEMPTS} "
          f"profiler traces whole; the last lost the device records of "
          f"{len(lost)} of {len(issued)} issued launches and copies, kept "
          f"{len(pad)} of {2 * PROFILE_PAD} padding records (apart: {apart}) "
          f"and {len(device)} of the work's {sum(names.values())}")
    return None


def busy_intervals(device) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals (us), in order."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def by_kernel(device) -> Dict[str, float]:
    """Device seconds by kernel name (templates and arguments dropped)."""
    out: Dict[str, float] = {}
    for e in device:
        k = kernel_name(e.name)
        out[k] = out.get(k, 0.0) + e.time_range.elapsed_us() * 1e-6
    return out


def idle_by_host(busy: List[Tuple[float, float]], host, top: int = 10
                 ) -> List[List]:
    """The idle gaps between device operations, each put to the innermost
    operation of the launching thread running at its middle (``host`` if
    none), summed by that operation's name: the ``top`` largest [name,
    seconds]."""
    threads: Dict[int, int] = {}
    for e in host:
        threads[e.thread] = threads.get(e.thread, 0) + 1
    main = max(threads, key=threads.get) if threads else None
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in host if e.thread == main),
                   key=lambda s: (s[0], -s[1]))
    gaps = sorted(((a + b) / 2, (b - a) * 1e-6)
                  for (_, a), (b, _) in zip(busy, busy[1:]))
    out: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for mid, seconds in gaps:      # a sweep: the host's spans nest
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host"
        out[name] = out.get(name, 0.0) + seconds
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def by_kernel_counts(device) -> Dict[str, int]:
    """Launches by kernel name."""
    out: Dict[str, int] = {}
    for e in device:
        k = kernel_name(e.name)
        out[k] = out.get(k, 0) + 1
    return out
