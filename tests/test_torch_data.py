"""The port's copy of the data pipeline and its `make_batch` against the
reference's: the same numpy draws give the same tokens and inputs, bit
for bit."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.data import pipeline as jpipe
from repro.launch import shapes as jshapes
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import shapes as tshapes


@pytest.mark.parametrize("mixture", [True, False])
def test_token_stream_equals_the_reference(mixture):
    """Seeds, shards and steps (in and out of order), both layouts."""
    for seed, shards, vocab, seq in ((0, 1, 256, 64), (3, 2, 49152, 96),
                                     (11, 4, 50, 33)):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=4, seed=seed,
                  num_shards=shards, mixture_docs=mixture)
        for shard in range(shards):
            ref = jpipe.TokenStream(jpipe.DataConfig(**kw), shard)
            port = tpipe.TokenStream(tpipe.DataConfig(**kw), shard)
            for step in (0, 1, 7, 1000, 3):
                a, b = ref.batch_at(step), port.batch_at(step)
                assert a.keys() == b.keys() == {"tokens", "labels"}
                for k in a:
                    assert a[k].dtype == b[k].dtype == np.int32
                    np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_and_pipeline_state_equal_the_reference():
    kw = dict(vocab_size=300, seq_len=40, global_batch=2, seed=2)
    ref = jpipe.Prefetcher(jpipe.TokenStream(jpipe.DataConfig(**kw), 0),
                           start_step=5)
    port = tpipe.Prefetcher(tpipe.TokenStream(tpipe.DataConfig(**kw), 0),
                            start_step=5)
    for _ in range(4):
        (sa, a), (sb, b) = ref.next(), port.next()
        assert sa == sb
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    st = tpipe.PipelineState(step=port.step)
    assert st.to_bytes() == jpipe.PipelineState(step=ref.step).to_bytes()
    assert tpipe.PipelineState.from_bytes(st.to_bytes()).step == 9
    with pytest.raises(ValueError, match="shard"):
        tpipe.TokenStream(tpipe.DataConfig(**kw), 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm-360m", "phi-3-vision-4.2b",
                                  "musicgen-large"])
def test_make_batch_equals_the_reference(arch, dtype):
    cfg = smoke_config(arch).scaled(dtype=dtype)
    ref = jshapes.make_batch(cfg, np.random.default_rng(8), batch=3, seq=20)
    port = tshapes.make_batch(cfg, np.random.default_rng(8), batch=3,
                              seq=20, device="cpu")
    assert ref.keys() == port.keys()
    for k, a in ref.items():
        a = np.asarray(a)
        b = port[k]
        if a.dtype == ml_dtypes.bfloat16:
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.astype(np.float32),
                                          b.float().numpy())
        else:
            assert str(b.dtype) == f"torch.{a.dtype}"
            np.testing.assert_array_equal(a, b.numpy())
    jt = jshapes.make_decode_tokens(cfg, np.random.default_rng(9), 4)
    tt = tshapes.make_decode_tokens(cfg, np.random.default_rng(9), 4,
                                    device="cpu")
    np.testing.assert_array_equal(np.asarray(jt.astype(jnp.float32)),
                                  tt.float().numpy())
