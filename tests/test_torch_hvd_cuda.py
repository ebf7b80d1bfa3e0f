"""The Horovod eager lane on the card: NCCL at world size 1.

Runs only where CUDA is available (``cuda_sm90`` marker, as the kernel
tests); elsewhere every test skips. One card gives a world of one, so
every op returns its input up to the scales: with prescale 2 and
postscale 0.25 a float result is exactly half its input (powers of two
round exactly) and an integer result ``trunc(x * 2 * 0.25)``. Each op
must leave its result on the card, make one NCCL call per response and
none on gloo; Average returns bf16 gradients bit for bit; a tensor
produced on a side stream behind a long kernel is read only once its
producer has written it.
"""

import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda_sm90

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def hvd():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")
    import horovod_tpu_torch.torch as hvd

    hvd.init()
    yield hvd
    hvd.shutdown()


def _responses(hvd):
    """CUDA responses run so far (the metrics registry)."""
    return sum(c["responses"] for c in hvd.metrics()["device_ops"].values())


@pytest.fixture
def lane(hvd):
    from horovod_tpu_torch.common import basics

    rt = basics.lane()
    rt.data_plane.reset_counts()
    before = _responses(hvd)
    yield rt
    dp = rt.data_plane
    assert dp.launches["gloo"] == 0, dict(dp.launches)
    assert dp.launches["nccl"] == _responses(hvd) - before, (
        dict(dp.launches), hvd.metrics()["device_ops"])


def _input(dtype, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype in (torch.int32, torch.int64):
        return torch.randint(-9, 10, shape, generator=g, device="cuda",
                             dtype=dtype)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _scaled(x):
    if x.dtype.is_floating_point:
        return x * 0.5
    return torch.trunc(x.double() * 2 * 0.25).to(x.dtype)


DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("op", ["Sum", "Average", "Min", "Max", "Product",
                                "Adasum"])
def test_allreduce_on_nccl(hvd, lane, dtype, op):
    if op == "Adasum" and not dtype.is_floating_point:
        pytest.skip("Adasum takes floating dtypes only")
    x = _input(dtype, (33, 7), 1)
    out = hvd.allreduce(x, op=getattr(hvd, op), prescale_factor=2.0,
                        postscale_factor=0.25)
    assert out.is_cuda and out.dtype == dtype
    torch.testing.assert_close(out, _scaled(x), rtol=0, atol=0)
    y = x.clone()
    ptr = y.data_ptr()
    hvd.allreduce_(y, op=getattr(hvd, op), prescale_factor=2.0,
                   postscale_factor=0.25)
    assert y.data_ptr() == ptr
    torch.testing.assert_close(y, _scaled(x), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_grouped_allreduce_on_nccl(hvd, lane, dtype):
    xs = [_input(dtype, (5 + i, 3), i) for i in range(3)]
    ys = [x.clone() for x in xs]
    ptrs = [y.data_ptr() for y in ys]
    hvd.grouped_allreduce_(ys, op=hvd.Sum, prescale_factor=2.0,
                           postscale_factor=0.25)
    assert [y.data_ptr() for y in ys] == ptrs
    outs = hvd.grouped_allreduce(xs, op=hvd.Average, prescale_factor=2.0,
                                 postscale_factor=0.25)
    for x, y, o in zip(xs, ys, outs):
        torch.testing.assert_close(y, _scaled(x), rtol=0, atol=0)
        torch.testing.assert_close(o, _scaled(x), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gather_broadcast_alltoall_reducescatter_on_nccl(hvd, lane, dtype):
    x = _input(dtype, (6, 4), 2)
    for out in (hvd.allgather(x), hvd.broadcast(x, root_rank=0),
                hvd.alltoall(x, splits=[6]), hvd.alltoall(x),
                hvd.reducescatter(x, op=hvd.Sum)):
        assert out.is_cuda
        torch.testing.assert_close(out, x, rtol=0, atol=0)
    y = x.clone()
    hvd.broadcast_(y, root_rank=0)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    for out in hvd.grouped_allgather([x, x[:2]]) + \
            hvd.grouped_reducescatter([x, x[:3]], op=hvd.Max):
        assert out.is_cuda
    torch.testing.assert_close(
        hvd.reducescatter(x, op=hvd.Average, prescale_factor=2.0,
                          postscale_factor=0.25), _scaled(x), rtol=0, atol=0)


def test_average_returns_bf16_gradients_bit_for_bit(hvd, lane):
    grads = [_input(torch.bfloat16, shape, i) for i, shape in enumerate(
        [(2048, 512), (14, 2048), (3, 1024, 1024), (4096,)])]
    want = [g.clone() for g in grads]
    hvd.grouped_allreduce_(grads, op=hvd.Average)
    handles = [hvd.allreduce_async_(g, name=f"bits.{i}")
               for i, g in enumerate(grads)]
    for h in handles:
        h.synchronize()
    for g, w in zip(grads, want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))


def test_side_stream_producer_is_waited_for(hvd, lane):
    x = torch.zeros(1 << 20, device="cuda")
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e8))       # ~0.1 s queued before the write
        x.fill_(3.0)
        h = hvd.allreduce_async(x, op=hvd.Sum)
        out = h.synchronize()
        got = out.cpu()
    assert bool((got == 3.0).all()), got.unique()


def test_poll_completes(hvd, lane):
    h = hvd.allreduce_async(torch.ones(8, device="cuda"), op=hvd.Sum)
    out = h.synchronize()
    torch.cuda.synchronize()
    assert h.poll() and torch.equal(out.cpu(), torch.ones(8))


def test_cuda_tensor_on_a_cpu_lane_raises():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    code = (
        "import torch\n"
        "import horovod_tpu_torch.torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "try:\n"
        "    hvd.allreduce(torch.ones(2, device='cuda'))\n"
        "except ValueError as e:\n"
        "    assert 'never' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no error')\n"
        "hvd.shutdown()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
