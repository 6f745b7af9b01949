"""repro_torch — the PyTorch + CUDA port of ``repro``.

The package mirrors ``repro``'s layout (``checkpoint``, ``configs``,
``core``, ``data``, ``dist``, ``infer``, ``kernels``, ``launch``,
``models``, ``obs``, ``optim``, ``serve``, ``train``) so every module has
a named counterpart. It imports ``torch``, numpy and scipy only — never JAX and
nothing of ``repro``. Every kernel that ``repro`` wrote in Pallas for the
TPU is a CUDA C++ kernel here (``kernels/csrc``), built with ``nvcc`` for
``sm_90a`` at first use and bound through ``ctypes``; each sits beside a
plain PyTorch version of the same function, which a wrapper runs only for
a tensor on the CPU.

Entry points (``serve.ServeEngine``, ``models.model.init``,
``convert.params_from_jax``, ``infer.coverage_run``,
``core.rcsl.make_shards``, ``train.step.make_train_step``,
``data.lm_batch``, ``python -m repro_torch.launch.train``) run on the
card unless the caller passes ``device="cpu"``; with no card and no
device they raise. ``core.rcsl.rcsl``
and ``infer.infer`` run where their tensors live.

Importing the package imports nothing: ``resolve_device`` loads on first
access, so the stdlib-only half of ``obs`` imports where torch is absent.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
