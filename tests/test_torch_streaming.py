"""Port parity: cortex_tpu_torch.parallel's streaming against cortex_tpu's.

``stream_filter`` and ``StreamingSession`` feed the same numpy chunks to the
same HGF in both packages, on the CPU (``device="cpu"``: the functions run in
order; the side-stream copy is held on the card by tests/test_torch_cuda.py).
Bar: rtol 1e-5, tests/test_hgf.py's for chunked streaming.
"""

import numpy as np
import pytest
import torch

import jax
from cortex_tpu_torch.models import HGF
from cortex_tpu_torch.parallel import StreamingSession, stream_filter

from cortex_tpu.models import HGF as JaxHGF
from cortex_tpu.parallel.streaming import StreamingSession as JaxSession
from cortex_tpu.parallel.streaming import stream_filter as jax_stream_filter

R_, T_ = 8, 96


def _u(seed):
    return np.random.default_rng(seed).normal(size=(R_, T_)).astype(np.float32)


def _chunks(u, width):
    return [u[:, i:i + width] for i in range(0, u.shape[1], width)]


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("width", [32, 96, 7], ids=["4-chunks", "1-chunk", "ragged"])
def test_stream_filter_matches_jax(width):
    u = _u(0)
    model, jax_model = HGF(), JaxHGF()
    chunks = _chunks(u, width)
    final, outs = stream_filter(lambda st, c: model.filter(c, state=st), chunks,
                                model.init_state((R_,), device="cpu"), device="cpu")
    want, jax_outs = jax_stream_filter(jax.jit(lambda st, c: jax_model.filter(c, state=st)),
                                       chunks, jax_model.init_state((R_,)))
    assert len(outs) == len(jax_outs) == len(chunks)
    for g, w in zip(final, want):
        _close(g, w)
    # Each chunk's trajectory too: the last chunk's mu2 track.
    _close(outs[-1].mu2, jax_outs[-1].mu2)


def test_streaming_session_matches_jax():
    u = _u(1)
    model, jax_model = HGF(omega=-3.0), JaxHGF(omega=-3.0)
    session = StreamingSession(lambda st, c: model.filter(c, state=st, tracks=()),
                               model.init_state((R_,), device="cpu"), device="cpu")
    jax_session = JaxSession(jax.jit(lambda st, c: jax_model.filter(c, state=st, tracks=())),
                             jax_model.init_state((R_,)))
    for chunk in _chunks(u, 16):
        session.push(chunk)
        jax_session.push(chunk)
    final, want = session.flush(), jax_session.flush()
    assert len(session.outputs) == len(jax_session.outputs) == 6
    for g, w in zip(final, want):
        _close(g, w)
    batch, _ = model.filter(torch.from_numpy(u), tracks=())
    for g, w in zip(final, batch):
        assert torch.equal(g, w)  # the same float32 operations in the same order


def test_empty_stream_returns_the_initial_state():
    model = HGF()
    init = model.init_state((R_,), device="cpu")
    final, outs = stream_filter(lambda st, c: model.filter(c, state=st), [], init, device="cpu")
    assert final is init and outs == []
    session = StreamingSession(lambda st, c: model.filter(c, state=st), init, device="cpu")
    assert session.flush() is init and session.outputs == []


def test_tensor_chunks_and_a_none_end_the_stream():
    """Chunks may be tensors or arrays; a None chunk ends the stream, as in JAX."""
    u = _u(2)
    model = HGF()
    chunks = [torch.from_numpy(u[:, :48]), u[:, 48:], None, u]
    final, outs = stream_filter(lambda st, c: model.filter(c, state=st, tracks=()), chunks,
                                model.init_state((R_,), device="cpu"), device="cpu")
    want, _ = model.filter(torch.from_numpy(u), tracks=())
    assert len(outs) == 2
    for g, w in zip(final, want):
        assert torch.equal(g, w)
