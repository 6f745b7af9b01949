"""Device resolution shared by every entry point of the port, and a check
of which device kernels a call runs."""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. With no card present that raises: there is
    no silent CPU path. Pass ``device="cpu"`` to run on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)


def kernels_in_calls(fns: Sequence[Callable[[], object]]) -> List[List[str]]:
    """For each call in ``fns`` (after a warm-up call of each), the names of
    the device kernels it runs, from ONE trace of
    :func:`device_kernel_events` (which opens with fills the tracer may
    drop): a spin kernel (``torch.cuda._sleep``) before each call and after
    the last marks where one call's kernels end. The tracer can lose
    events, so a trace that does not split into one group a call is taken
    again, up to three times in all, before this raises. A call that runs
    other than one kernel still splits, and its caller sees it."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()

    def run():
        for fn in fns:
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)

    for _ in range(3):
        _, evs = device_kernel_events(run)
        calls: List[List[str]] = []
        for name, _ in evs:
            if "spin_kernel" in name:
                calls.append([])
            elif calls:
                calls[-1].append(name)
        if len(calls) == len(fns) + 1 and not calls[-1]:
            return calls[:-1]
    raise RuntimeError(f"profiler trace not split into {len(fns)} calls: "
                       f"{[name[:50] for name, _ in evs]}")


# a trace opens with this many small fills, then a ~2 ms device spin: the
# tracer drops a trace's first device events (more of them the longer the
# process has run), and these take their place
TRACE_FILLS, TRACE_SPIN_CYCLES = 64, 4_000_000


def device_kernel_events(fn: Callable[[], object], tries: int = 3
                         ) -> Tuple[object, List[Tuple[str, float]]]:
    """(``fn()``, the device kernels that ran during the call in launch
    order, each as (name, device µs)) from one ``torch.profiler`` trace:
    those a CUDA graph's replay launched as well as eager launches. The
    trace opens with ``TRACE_FILLS`` fills and a device spin, run to
    completion; the call's kernels are those after the spin. A trace that
    holds no spin (no device event at all, or too many dropped) is taken
    again, with ``fn`` called again, up to ``tries`` times in all, before
    this raises: a call that draws from a generator must seed it anew each
    time, or its second run starts where the first left off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_FILLS):
                torch.zeros(1, device="cuda")
            torch.cuda._sleep(TRACE_SPIN_CYCLES)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        # the raw events: no per-event parsing, which a trace of thousands
        # of launches would spend seconds on
        evs = sorted((ev.start_ns(), ev.name(), ev.duration_ns() / 1e3)
                     for ev in prof.profiler.kineto_results.events()
                     if ev.device_type() == DeviceType.CUDA)
        spin = next((i for i, ev in enumerate(evs)
                     if "spin_kernel" in ev[1]), None)
        if spin is not None:
            return out, [(name, us) for _, name, us in evs[spin + 1:]]
    raise RuntimeError(f"{tries} profiler traces held no spin to split at")


def device_kernel_counts(fn: Callable[[], object], names: Sequence[str],
                         tries: int = 3) -> Tuple[object, Dict[str, int]]:
    """(``fn()``, for each of ``names`` the device kernels of the call
    whose name holds it), from :func:`device_kernel_events`."""
    out, evs = device_kernel_events(fn, tries)
    return out, {n: sum(n in name for name, _ in evs) for n in names}


def kernel_instance(name: str, kernel: str) -> Optional[Tuple[int, ...]]:
    """The integer template arguments of a device kernel's name, demangled
    (``decode_split_kernel<96, 16, ...>``) or mangled
    (``decode_split_kernelILi96ELi16E...``): which instance of ``kernel``
    ran. None for another kernel."""
    m = re.search(rf"{kernel}<([\d, ]+)[,>]", name)
    if m:
        return tuple(int(a) for a in m.group(1).split(",") if a.strip())
    m = re.search(rf"{kernel}I((?:Li\d+E)+)", name)
    if m:
        return tuple(int(a) for a in re.findall(r"Li(\d+)E", m.group(1)))
    return None
