"""Host -> device input pipeline (`intrepppid_tpu/data/pipeline.py`
counterpart).

Two stages that overlap the card's steps:

* :func:`host_prefetch` runs a host batch iterator (tokenisation: the
  native tokenizer releases the GIL during its C++ batch call) in a
  background thread with a bounded queue;
* :func:`prefetch_to_device` copies each batch to the card from pinned host
  memory on a side CUDA stream, in its own thread, so batch N+1 streams to
  the card while the consumer's stream runs step N.

A key that starts with ``_`` (the data module's ``_global_rows``) is host
metadata: it passes through both stages as it is. The JAX module's
``sharding`` argument has no counterpart: under data parallelism each
process copies its own rows to its own card.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch

from intrepppid_tpu_torch.models.triplet import TOKEN_KEYS

_SENTINEL = object()


def _threaded_iter(
    batches: Iterator,
    size: int,
    transform: Optional[Callable] = None,
) -> Iterator:
    """Run ``batches`` (optionally mapped through ``transform``) in a
    background thread with a bounded hand-off queue.

    Shutdown-safe: if the consumer abandons the generator mid-stream
    (exception in the training loop, partial drain), closing it signals the
    producer via a stop event and drains the queue, so the thread exits
    instead of blocking forever in ``q.put`` holding batches.
    Upstream exceptions re-raise in the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    err: list = []
    stop = threading.Event()

    def produce():
        try:
            for item in batches:
                item = transform(item) if transform is not None else item
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # propagate into the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break


def host_prefetch(batches: Iterator, size: int = 2) -> Iterator:
    """Run a host batch iterator in its own background thread.

    Stacked in front of :func:`prefetch_to_device` this splits the input
    pipeline into two concurrent stages, tokenisation (this thread) and the
    copy to the card (the prefetch thread), so batch N+2 tokenises while
    batch N+1 streams to the card and batch N runs. The bounded queue
    ``size`` keeps at most that many batches of host RAM in flight.
    """
    return _threaded_iter(batches, size)


def host_tensors(batch: Mapping[str, Any]) -> Dict[str, Any]:
    """A numpy batch as CPU tensors, the token ids widened to int64 (the
    embedding's index type); other keys keep their dtype, and ``_`` keys
    (host metadata) their value."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            out[k] = v
            continue
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.long() if k in TOKEN_KEYS else t
    return out


def prefetch_to_device(
    batches: Iterator[Mapping[str, Any]],
    device: Union[str, torch.device],
    size: int = 2,
) -> Iterator[Dict[str, Any]]:
    """Batches of tensors on ``device``, ``size`` batches ahead.

    On a card: a thread widens each batch's ids to int64 on the host, pins
    it and copies it on a side stream, recording an event; the consumer's
    stream waits on that event before the batch is yielded, and every
    tensor is ``record_stream``-ed on it, so the caching allocator does not
    hand its memory to the side stream while the consumer's work may still
    read it. On the CPU it only makes the tensors (``host_tensors``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return (host_tensors(b) for b in batches)
    return _cuda_prefetch(batches, device, size)


def _cuda_prefetch(batches, device: torch.device, size: int) -> Iterator[Dict[str, Any]]:
    side = torch.cuda.Stream(device)

    def copy(batch):
        host = host_tensors(batch)
        meta = {k: v for k, v in host.items() if k.startswith("_")}
        pinned = {k: t.pin_memory() for k, t in host.items() if k not in meta}
        with torch.cuda.device(device), torch.cuda.stream(side):
            out = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(side)
        return {**out, **meta}, done

    for out, done in _threaded_iter(batches, size, copy):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for t in out.values():
            if isinstance(t, torch.Tensor):
                t.record_stream(stream)
        yield out
