"""The port's one way to open a ``torch.profiler`` range.

``ranged(name)`` opens a host range named ``name`` while a profiler is
running and is a no-op context otherwise. With no profiler running,
entering a ``record_function`` took 9.8-10.1 us and ``ranged`` 0.11 us
more than a bare ``with`` on the host of an H100 machine (torch 2.11),
and the decode step opens one range a layer.

The range is an operator-scope one (``_RecordFunctionFast``, which
``torch.fx`` uses for its graph ranges), not a ``record_function``, for
its cost under a profiler: 3.0 us an enter and exit on the same host,
against 17.3 us for a ``record_function``, whose args and device-side copy
this port's readers do not use. It leaves no event on the device's
timeline; readers join a range to its device work through the launches
made inside it (their correlation ids).

The serving engine and the model step open these ranges;
``launch/trace_serve.py`` reads them all, ``portbench/trace.py`` the
engine's prefill and decode step:

* ``engine.admit``: ``ServingEngine._admit`` when it has a request to admit
  (queue pops, padding, the upload, the prefills, the first tokens'
  readback, the cache inserts);
* ``engine.prefill``: one request's prefill, inside ``engine.admit``;
* ``engine.decode_step``: the model's decode step over the batch;
* ``engine.retire``: the decode step's token readback and the retire loop;
* ``decode.attend``: one layer's decode attention (the cache writes and
  ``attend``, or the sharded flash decode on a mesh);
* ``layer.moe``: one layer's MoE block (prefill, decode and training).
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_host_range = torch._C._profiler._RecordFunctionFast


def ranged(name: str):
    """A host range named ``name`` while a profiler runs; a context that
    does nothing otherwise."""
    return _host_range(name) if _profiling() else _NULL
