"""Stage annotation for device profiles (port of ``annotate`` in
``repro/obs/trace.py``; the host ``Tracer`` is not ported yet).

``annotate(name)`` opens a ``torch.profiler.record_function`` range (it
shows in ``torch.profiler`` traces) and, when a GPU is present, an NVTX
range of the same name. Metadata only: numerics are unchanged.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def annotate(name: str):
    """Name a stage for ``torch.profiler`` and NVTX timelines."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
