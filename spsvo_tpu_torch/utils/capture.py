"""CUDA-graph capture: what code that may run under one has to ask, and
the iteration of a data-dependent loop that a captured program skips on
the device (a conditional IF node, through the CUDA driver API)."""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Dict, Iterator, Tuple

import torch


def host_may_read(x: torch.Tensor) -> bool:
    """Whether a value of `x` may be read on the host now: not while its
    stream is being captured into a CUDA graph."""
    return not (x.is_cuda and torch.cuda.is_current_stream_capturing())


def iterate(go: torch.Tensor, body: Callable[[], None], loop: str) -> bool:
    """One iteration of a data-dependent loop: `body` updates the loop's
    carry in place where the 0-dim bool `go` holds. The body keeps its own
    lane masks, so run where `go` is false it leaves the carry as it was.

    Where the host may read `go` (`host_may_read`), it is read, and false
    ends the loop: returns False, `body` not run. Under a CUDA-graph
    capture `body` is captured as the body of a conditional IF node on
    `go` (`if_node`), so a replay launches it only where `go` holds on the
    device, as the eager loop ends; off the card (a CPU tensor the host may
    not read) it runs, masked. With the capture traced
    (`utils.profiling`), `loop` names the body's counters."""
    if host_may_read(go):
        if not bool(go):
            return False
        body()
        return True
    if not go.is_cuda:
        body()
        return True
    with if_node(go, loop):
        body()
    return True


# CUDA driver API values (cuda.h)
_COND_NODE = 13               # CU_GRAPH_NODE_TYPE_CONDITIONAL
_COND_IF = 0                  # CU_GRAPH_COND_TYPE_IF
_ASSIGN_DEFAULT = 1           # CU_GRAPH_COND_ASSIGN_DEFAULT
_SET_DEPENDENCIES = 1         # CU_STREAM_SET_CAPTURE_DEPENDENCIES
_CAPTURE_THREAD_LOCAL = 1     # CU_STREAM_CAPTURE_MODE_THREAD_LOCAL
_NON_BLOCKING = 1             # CU_STREAM_NON_BLOCKING


class _CondParams(ctypes.Structure):
    """CUDA_CONDITIONAL_NODE_PARAMS."""
    _fields_ = [("handle", ctypes.c_uint64), ("type", ctypes.c_int),
                ("size", ctypes.c_uint),
                ("phGraph_out", ctypes.POINTER(ctypes.c_void_p)),
                ("ctx", ctypes.c_void_p)]


class _NodeParams(ctypes.Structure):
    """CUgraphNodeParams: the node's type, then a union of 29 long longs
    (here its conditional member)."""
    _fields_ = [("type", ctypes.c_int), ("reserved0", ctypes.c_int * 3),
                ("conditional", _CondParams),
                ("union_rest", ctypes.c_byte * (29 * 8
                                                - ctypes.sizeof(_CondParams))),
                ("reserved2", ctypes.c_longlong)]


_V, _P, _S = ctypes.c_void_p, ctypes.POINTER, ctypes.c_size_t
_SIGNATURES = {
    "cuStreamGetCaptureInfo_v2": [_V, _P(ctypes.c_int), _P(ctypes.c_uint64),
                                  _P(_V), _P(_V), _P(_S)],
    "cuCtxGetCurrent": [_P(_V)],
    "cuGraphConditionalHandleCreate": [_P(ctypes.c_uint64), _V, _V,
                                       ctypes.c_uint, ctypes.c_uint],
    "cuGraphAddNode": [_P(_V), _V, _V, _S, _P(_NodeParams)],
    "cuStreamUpdateCaptureDependencies": [_V, _P(_V), _S, ctypes.c_uint],
    "cuStreamBeginCaptureToGraph": [_V, _V, _V, _V, _S, ctypes.c_int],
    "cuStreamEndCapture": [_V, _P(_V)],
    "cuStreamCreate": [_P(_V), ctypes.c_uint],
    "cuGraphGetNodes": [_V, _V, _P(_S)],
    "cuGraphNodeGetType": [_V, _P(ctypes.c_int)],
}


@functools.lru_cache(maxsize=None)
def _driver_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def driver(name: str, *args) -> None:
    """Call the CUDA driver API's `name`; raise on an error."""
    err = getattr(_driver_lib(), name)(*args)
    if err:
        raise RuntimeError(f"{name} failed: CUresult {err}")


def capture_of(stream: torch.cuda.Stream) -> Tuple[int, int]:
    """(capture id, CUgraph) of the capture in progress on `stream`."""
    status, cid, graph = ctypes.c_int(0), ctypes.c_uint64(0), _V(0)
    driver("cuStreamGetCaptureInfo_v2", _V(stream.cuda_stream),
           ctypes.byref(status), ctypes.byref(cid), ctypes.byref(graph),
           None, None)
    return cid.value, graph.value


# per device: the stream the bodies are captured on (made here, so never
# one of PyTorch's pooled streams, which a capture may already be using),
# and the memory pool their tensors come from
_bodies: Dict[int, Tuple[torch.cuda.ExternalStream, tuple]] = {}


def _body_stream_and_pool(dev: torch.device):
    """The bodies' stream and memory pool on `dev`, made at its first IF
    node."""
    if dev.index not in _bodies:
        raw = _V(0)
        with torch.cuda.device(dev):
            driver("cuStreamCreate", ctypes.byref(raw), _NON_BLOCKING)
        _bodies[dev.index] = (torch.cuda.ExternalStream(raw.value,
                                                        device=dev),
                              torch.cuda.graph_pool_handle())
    return _bodies[dev.index]


@functools.lru_cache(maxsize=None)
def _set_if():
    """`csrc/graph_if.cu`'s launch, built at the first IF node."""
    from spsvo_tpu_torch import _build
    fn = _build.load("graph_if").graph_if_set
    fn.argtypes = [ctypes.c_uint64, _V, _V]
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def if_node(go: torch.Tensor, loop: str) -> Iterator[None]:
    """Under a CUDA-graph capture on the current stream: what runs inside
    is captured as the body of a conditional IF node on the 0-dim bool
    `go`, which a replay launches only where `go` holds.

    A kernel (`csrc/graph_if.cu`) sets the node's value from `go` ahead of
    it; the node then follows it in the capture, and what is captured
    after it follows the node. The body is captured on a stream of its
    own into the node's body graph, its tensors allocated from one memory
    pool that every body on the device shares and never frees: a body's
    tensors die with it (its results are copies into tensors made before
    the loop), and bodies run one at a time, so no two replays of graphs
    with bodies may overlap."""
    from spsvo_tpu_torch.utils import profiling
    if go.dtype != torch.bool or go.numel() != 1:
        raise ValueError("an IF node's predicate is one bool")
    dev = go.device
    parent = torch.cuda.current_stream(dev)
    cid, graph = capture_of(parent)
    ran = profiling.loop_counter(cid)       # made before the node
    ctx, handle = _V(0), ctypes.c_uint64(0)
    driver("cuCtxGetCurrent", ctypes.byref(ctx))
    driver("cuGraphConditionalHandleCreate", ctypes.byref(handle), _V(graph),
           ctx, 0, _ASSIGN_DEFAULT)
    err = _set_if()(handle.value, _V(go.data_ptr()), _V(parent.cuda_stream))
    if err:
        raise RuntimeError(f"graph_if_set: cudaError {err}")
    status, deps, n_deps = ctypes.c_int(0), _V(0), _S(0)
    driver("cuStreamGetCaptureInfo_v2", _V(parent.cuda_stream),
           ctypes.byref(status), None, None, ctypes.byref(deps),
           ctypes.byref(n_deps))
    params = _NodeParams(type=_COND_NODE)
    params.conditional.handle = handle.value
    params.conditional.type = _COND_IF
    params.conditional.size = 1
    params.conditional.ctx = ctx
    node = _V(0)
    driver("cuGraphAddNode", ctypes.byref(node), _V(graph), deps, n_deps,
           ctypes.byref(params))
    body = params.conditional.phGraph_out[0]
    driver("cuStreamUpdateCaptureDependencies", _V(parent.cuda_stream),
           ctypes.byref(node), 1, _SET_DEPENDENCIES)
    stream, pool = _body_stream_and_pool(dev)
    driver("cuStreamBeginCaptureToGraph", _V(stream.cuda_stream), _V(body),
           None, None, 0, _CAPTURE_THREAD_LOCAL)
    # this thread's allocations into the bodies' pool
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool)
    try:
        with torch.cuda.stream(stream):
            yield
            profiling.body_captured(cid, loop, ran, body)
    finally:
        torch._C._cuda_endAllocateToPool(dev.index, pool)
        done = _V(0)
        driver("cuStreamEndCapture", _V(stream.cuda_stream),
               ctypes.byref(done))
