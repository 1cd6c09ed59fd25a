"""The W8A16 path on the CPU: the wrapper's plain version is `x @ wcast(w,
x.dtype)` bit for bit; the choice of path (`quant.takes_kernel`) from
shape, dtype and device alone, on either side of the 64-row limit (CUDA
tensors made under FakeTensorMode, the launch replaced by a stub); the
call sites send the kernel its calls and `wcast` the rest, through their
own module's name; the tracer's two counters; every int8 matmul shape of
the configured archs taken; and the kernel's Stream-K cut (`ref.py`)
covering every k tile once and summing to the product."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.kernels.w8a16 import ops, ref
from repro_torch.models import init_cache, layers, mamba2, moe, quant
from repro_torch.models import model as tmodel
from repro_torch.models.model import init_params, init_quantized_params
from repro_torch.obs import spans
from torch_w8a16_cases import INT8_MATMUL_SHAPES, SERVE_CHAT

PHI = "phi3.5-moe-42b-a6.6b"


@pytest.fixture(autouse=True)
def fresh_tracer():
    spans.collect()
    yield
    spans.collect()


@pytest.fixture
def stub_launch(monkeypatch):
    """The kernel's launch replaced by a recorder: (x, q) shapes a call,
    an empty output of the right shape."""
    calls = []

    def launch(x, q, s, blocks=None):
        calls.append((tuple(x.shape), tuple(q.shape)))
        return x.new_empty(x.shape[:-1] + (q.shape[-1],))
    monkeypatch.setattr(ops, "_launch", launch)
    return calls


@pytest.fixture
def wcast_calls(monkeypatch):
    """`layers.wcast` and `moe.wcast` replaced by recorders that hand back
    an empty weight of the product's shape (a fake CUDA tensor cannot be
    indexed on a CPU-only build)."""
    calls = []

    def recorder(module):
        def wcast(w, dtype):
            calls.append(module)
            q = w["q"] if quant.is_quantized(w) else w
            return torch.empty(q.shape, dtype=dtype, device=q.device)
        return wcast
    monkeypatch.setattr(layers, "wcast", recorder("layers"))
    monkeypatch.setattr(moe, "wcast", recorder("moe"))
    return calls


def _int8(shape, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return quant.quantize_weight(torch.randn(shape, generator=g)
                                 .to(device=device))


def _fake_int8(shape):
    """An int8 weight of fake CUDA tensors (call under FakeTensorMode)."""
    return {"q": torch.empty(shape, dtype=torch.int8, device="cuda"),
            "s": torch.empty(shape[:-2] + shape[-1:], device="cuda")}


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_plain_version_is_x_at_wcast_bit_for_bit(batched, int8, dtype):
    g = torch.Generator().manual_seed(1)
    shape = (3, 96, 48) if batched else (96, 48)
    w = _int8(shape) if int8 else torch.randn(shape, generator=g).to(dtype)
    x = torch.randn(((3,) if batched else ()) + (5, 96), generator=g
                    ).to(dtype)
    want = x @ quant.wcast(w, x.dtype)
    assert torch.equal(ref.w8a16_ref(x, w), want)
    if int8:
        assert torch.equal(ops.w8a16_matmul(x, w), want)
    site = moe._expert_matmul if batched else layers.linear
    assert torch.equal(site(x, w) if batched else site(w, x), want)


def test_wrapper_refuses_a_gradient_and_a_cpu_launch():
    w = _int8((64, 32))
    x = torch.randn(4, 64, requires_grad=True)
    before = ops.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.w8a16_matmul(x, w)
    with pytest.raises(ValueError, match="no kernel"):
        ops._launch(x.detach().bfloat16(), w["q"], w["s"])
    assert ops.launches == before


# ---------------------------------------------------------------------------
# the choice of path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    # (x shape, weight shape, dtype, device, kernel)
    ((64, 4096), (4096, 1024), torch.bfloat16, "cuda", True),
    ((65, 4096), (4096, 1024), torch.bfloat16, "cuda", False),
    ((8, 8, 4096), (4096, 1024), torch.bfloat16, "cuda", True),     # 64 rows
    ((5, 13, 4096), (4096, 1024), torch.bfloat16, "cuda", False),   # 65
    ((32, 1, 4096), (4096, 4096), torch.bfloat16, "cuda", True),
    ((16, 64, 4096), (16, 4096, 6400), torch.bfloat16, "cuda", True),
    ((16, 65, 6400), (16, 6400, 4096), torch.bfloat16, "cuda", False),
    ((16, 5, 4096), (16, 4096, 6400), torch.float32, "cuda", False),
    ((32, 4096), (4096, 1024), torch.float32, "cuda", False),
    ((32, 4096), (4096, 1024), torch.bfloat16, "cpu", False),
    ((32, 4096), (4096, 24), torch.bfloat16, "cuda", False),         # N % 16
    ((32, 36), (36, 1024), torch.bfloat16, "cuda", False),           # K % 8
])
def test_choice_of_path_from_shape_dtype_and_device(case):
    xs, ws, dtype, device, kernel = case
    with FakeTensorMode():
        x = torch.empty(xs, dtype=dtype, device=device)
        w = {"q": torch.empty(ws, dtype=torch.int8, device=device),
             "s": torch.empty(ws[:-2] + ws[-1:], device=device)}
        assert quant.takes_kernel(w, x) is kernel
        # a dense weight never takes the kernel
        assert quant.takes_kernel(torch.empty(ws, dtype=dtype,
                                              device=device), x) is False


@pytest.mark.parametrize("rows,kernel", [(64, True), (65, False)])
def test_linear_sends_decode_shapes_to_the_kernel(rows, kernel, stub_launch,
                                                  wcast_calls):
    with FakeTensorMode():
        w = _fake_int8((256, 128))
        x = torch.empty(rows, 1, 256, dtype=torch.bfloat16, device="cuda")
        y = layers.linear(w, x)
    assert y.shape == (rows, 1, 128)
    assert stub_launch == ([((rows, 1, 256), (256, 128))] if kernel else [])
    assert wcast_calls == ([] if kernel else ["layers"])


@pytest.mark.parametrize("rows,kernel", [(5, True), (64, True),
                                         (65, False), (640, False)])
def test_experts_send_decode_shapes_to_the_kernel(rows, kernel, stub_launch,
                                                  wcast_calls):
    with FakeTensorMode():
        ws = [_fake_int8((4, 256, 384)), _fake_int8((4, 256, 384)),
              _fake_int8((4, 384, 256))]
        xe = torch.empty(4, rows, 256, dtype=torch.bfloat16, device="cuda")
        y = moe._experts(xe, *ws, "swiglu")
    assert y.shape == (4, rows, 256)
    if kernel:
        assert stub_launch == [((4, rows, 256), (4, 256, 384))] * 2 + \
            [((4, rows, 384), (4, 384, 256))]
        assert wcast_calls == []
    else:
        assert stub_launch == [] and wcast_calls == ["moe"] * 3


def test_names_the_benchmark_binds_stay_module_attributes():
    for mod, name in ((layers, "linear"), (layers, "wcast"), (moe, "wcast"),
                      (moe, "_route"), (moe, "_experts"),
                      (mamba2, "linear")):
        assert callable(getattr(mod, name)), (mod.__name__, name)
    assert layers.wcast is quant.wcast and moe.wcast is quant.wcast
    assert mamba2.linear is layers.linear


def test_a_prefill_reaches_wcast_through_each_callers_name(monkeypatch):
    """A Phi smoke prefill with int8 weights (CPU tensors and more than 64
    rows a matrix, either of which keeps it off the kernel) dequantizes
    its 7 int8 matmuls a layer through `layers.wcast` (4) and
    `moe.wcast` (3)."""
    cfg = smoke_config(PHI).scaled(dtype="bfloat16")
    params = init_quantized_params(cfg, 0, device="cpu")
    seen = []
    for mod in (layers, moe):
        real = mod.wcast

        def counted(w, dtype, _mod=mod.__name__, _real=real):
            seen.append(_mod.rsplit(".", 1)[1])
            return _real(w, dtype)
        monkeypatch.setattr(mod, "wcast", counted)
    tokens = torch.arange(2 * 64).reshape(2, 64) % cfg.vocab_size
    tmodel.prefill(params, {"tokens": tokens}, cfg, 64)
    L = cfg.num_layers
    assert seen.count("layers") == 4 * L and seen.count("moe") == 3 * L


# ---------------------------------------------------------------------------
# the tracer's counters
# ---------------------------------------------------------------------------


def test_quant_counters_count_only_with_the_tracer_on():
    cfg = smoke_config(PHI).scaled(dtype="bfloat16")
    params = init_quantized_params(cfg, 0, device="cpu")
    cache = init_cache(cfg, 4, 16, device="cpu")
    tokens = torch.zeros((4, 1), dtype=torch.int64)
    tmodel.decode_step(params, dict(cache), tokens, cfg)
    assert spans.collect()["counters"] == {}
    spans.enable()
    tmodel.decode_step(params, dict(cache), tokens, cfg)
    tmodel.prefill(params, {"tokens": tokens}, cfg, 16)
    counters = spans.collect()["counters"]
    # CPU tensors: every int8 matmul of the step and of the prefill is
    # dequantized; a dense tree counts none
    assert counters["quant.dequant_calls"] == 2 * 7 * cfg.num_layers
    assert "quant.kernel_calls" not in counters
    spans.enable()
    tmodel.decode_step(init_params(cfg, 0, device="cpu"), dict(cache),
                       tokens, cfg)
    assert not any(k.startswith("quant.")
                   for k in spans.collect()["counters"])


@pytest.mark.parametrize("rows,kernel", [(64, True), (65, False)])
def test_quant_counters_follow_the_choice(rows, kernel, stub_launch,
                                          wcast_calls):
    spans.enable()
    with FakeTensorMode():
        w = _fake_int8((256, 128))
        layers.linear(w, torch.empty(rows, 256, dtype=torch.bfloat16,
                                     device="cuda"))
        layers.linear(torch.empty(256, 128, dtype=torch.bfloat16,
                                  device="cuda"),
                      torch.empty(rows, 256, dtype=torch.bfloat16,
                                  device="cuda"))
    got = spans.collect()["counters"]
    assert got == {"quant.kernel_calls" if kernel
                   else "quant.dequant_calls": 1}


# ---------------------------------------------------------------------------
# the shapes the kernel takes, and its Stream-K cut
# ---------------------------------------------------------------------------


def test_every_int8_matmul_shape_of_the_configs_is_taken():
    found = set()

    def walk(node, name=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif name in quant._QUANT_SUFFIXES and node.ndim >= 2:
            found.add(tuple(node.shape[-2:]))
    for arch in ARCHS:
        walk(init_params(get_config(arch), device="meta"))
    assert sorted(found) == INT8_MATMUL_SHAPES
    for K, N in INT8_MATMUL_SHAPES:
        assert ops.takes(1, K, N) and ops.takes(64, K, N)
        assert not ops.takes(65, K, N)


@pytest.mark.parametrize("E,M,K,N,blocks", [
    (3, 5, 200, 272, 7), (2, 17, 960, 320, 5), (1, 32, 512, 384, 13),
    (4, 1, 64, 128, 4), (2, 8, 640, 256, 20), (1, 64, 1024, 128, 16),
])
def test_stream_k_cut_covers_every_k_tile_once_and_sums_to_the_product(
        E, M, K, N, blocks):
    w = _int8((E, K, N), seed=E + M)
    x = torch.randn(E, M, K, generator=torch.Generator().manual_seed(M)
                    ).bfloat16()
    nt, it, total = ref.iterations(E, K, N)
    plan = ref.merge_plan(E, K, N, blocks)
    assert len(plan) == E * nt
    held = {}
    for t, shares in enumerate(plan):
        assert sorted(k for _, _, r in shares for k in r) == list(range(it))
        assert [b for b, _, _ in shares] == sorted(b for b, _, _ in shares)
        for b, slot, _ in shares:
            if slot is not None:
                assert (b, slot) not in held, (t, b, slot)
                held[b, slot] = t
    # each block's runs, in order, cover the iterations once
    starts = [ref.run_start(b, total, blocks) for b in range(blocks + 1)]
    assert starts[0] == 0 and starts[-1] == total
    assert all(a < b for a, b in zip(starts, starts[1:]))
    for i in range(total):
        b = ref.owner(i, total, blocks)
        assert starts[b] <= i < starts[b + 1]
    y = ref.stream_k(x, w, blocks)
    want = x.float() @ (w["q"].float() * w["s"][:, None, :])
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", list(SERVE_CHAT))
def test_grid_fills_the_card_and_keeps_min_iters_a_block(name):
    E, M, K, N = SERVE_CHAT[name]
    E = E or 1
    _, _, total = ref.iterations(E, K, N)
    for per_sm in (1, 2, 4):
        G = ops.grid(E, K, N, per_sm, 132)
        assert 1 <= G <= per_sm * 132 and total // G >= ops.MIN_ITERS
        assert G == per_sm * 132 or G == total // ops.MIN_ITERS
    assert ops.workspace_floats(10, M) == 10 * 2 * 8 * ops.row_tiles(M) * 128
    assert [ops.row_tiles(m) for m in (1, 8, 9, 16, 17, 32, 33, 64)] == \
        [1, 1, 2, 2, 4, 4, 8, 8]
