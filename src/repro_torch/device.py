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
    the device kernels it runs, from ONE ``torch.profiler`` trace of the
    card: a spin kernel (``torch.cuda._sleep``) before each call and after
    the last marks where one call's kernels end. The tracer can lose
    events: it has dropped the first device event of a trace, and returned
    traces with no device event at all. So the trace opens with a small
    fill, run to completion, that the split ignores (a dropped first event
    is then that fill), and a trace that does not split into one group a
    call is taken again, up to three times in all, before this raises. A
    call that runs other than one kernel still splits, and its caller
    sees it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            for fn in fns:
                torch.cuda._sleep(1000)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        calls: List[List[str]] = []
        for ev in evs:
            if "spin_kernel" in ev.name:
                calls.append([])
            elif calls:
                calls[-1].append(ev.name)
        if len(calls) == len(fns) + 1 and not calls[-1]:
            return calls[:-1]
    raise RuntimeError(f"profiler trace not split into {len(fns)} calls: "
                       f"{[ev.name[:50] for ev in evs]}")


def device_kernel_counts(fn: Callable[[], object], names: Sequence[str],
                         tries: int = 3) -> Tuple[object, Dict[str, int]]:
    """(``fn()``, for each of ``names`` the device kernels whose name holds
    it) from one ``torch.profiler`` trace of the call: the kernels that
    ran on the card, those a CUDA graph's replay launched as well as eager
    launches. As in :func:`kernels_in_calls`, the trace opens with a small
    fill run to completion (the tracer has dropped a trace's first device
    event), and a trace with no device event at all is taken again, with
    ``fn`` called again, up to ``tries`` times in all, before this
    raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        # the raw events: no per-event parsing, which a trace of thousands
        # of launches would spend seconds on
        ran = [ev.name() for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA]
        if ran:
            return out, {n: sum(n in k for k in ran) for n in names}
    raise RuntimeError(f"{tries} profiler traces held no device event")


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
