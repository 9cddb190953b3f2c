"""The port's true-f32 scope (``diart_tpu_torch.ops._numerics``) on the CPU.

torch's TF32 switches are process-global flags that a CPU build holds too,
so the scope's bookkeeping is testable here: it clears both flags for a
CUDA device and puts the caller's back when it closes, when scopes nest,
when one closes on an exception and when scopes on two threads overlap.
Which convolutions enter it is checked with a recorder in its place that
forces the device to ``cuda`` (the CPU tensors' convolutions then run with
the flags cleared, as on the card).
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from diart_tpu_torch import precision
from diart_tpu_torch.models.common import QuantizableConv
from diart_tpu_torch.models.sincnet import SincConv, SincNet
from diart_tpu_torch.ops import _numerics

CUDA = torch.device("cuda")  # only a device object: nothing runs on it


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture(autouse=True)
def _caller_flags():
    """Each test starts from a caller whose flags differ from each other
    (cuDNN TF32 on, matmul TF32 off: torch's defaults) and ends there."""
    prev = _flags()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("caller", [(True, False), (True, True), (False, True), (False, False)])
def test_scope_clears_and_restores(caller):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = caller
    with _numerics.true_f32(CUDA):
        assert _flags() == (False, False)
    assert _flags() == caller
    with _numerics.true_f32("cpu"):  # another device: nothing to do
        assert _flags() == caller
    assert _flags() == caller


def test_scope_nests():
    with _numerics.true_f32(CUDA):
        with _numerics.true_f32(CUDA):
            assert _flags() == (False, False)
        assert _flags() == (False, False)  # the outer scope is still open
    assert _flags() == (True, False)


def test_scope_restores_on_exception():
    with pytest.raises(RuntimeError, match="inside"):
        with _numerics.true_f32(CUDA):
            with _numerics.true_f32(CUDA):
                raise RuntimeError("inside")
    assert _flags() == (True, False)
    # and the next scope starts from the caller's flags again
    torch.backends.cuda.matmul.allow_tf32 = True
    with _numerics.true_f32(CUDA):
        assert _flags() == (False, False)
    assert _flags() == (True, True)


def test_scopes_on_two_threads_overlap():
    """Thread A opens, thread B opens, A closes while B is open: the flags
    stay cleared until B closes, then the caller's come back."""
    a_open, b_open, a_closed, b_close = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with _numerics.true_f32(CUDA):
            a_open.set()
            b_open.wait(10)
        a_closed.set()

    def b():
        a_open.wait(10)
        with _numerics.true_f32(CUDA):
            b_open.set()
            a_closed.wait(10)
            seen["b_after_a"] = _flags()
            b_close.wait(10)

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    a_closed.wait(10)
    b_close.set()
    for t in threads:
        t.join(10)
    assert seen["b_after_a"] == (False, False)
    assert _flags() == (True, False)


def test_conv_scope_only_for_f32():
    with _numerics.conv_scope(CUDA, torch.bfloat16):
        assert _flags() == (True, False)
    with _numerics.conv_scope(CUDA, torch.float32):
        assert _flags() == (False, False)
    assert _flags() == (True, False)


# --------------------------------------------------------------------- #
# which convolutions enter the scope


@pytest.fixture
def entered(monkeypatch):
    """A recorder in the scope's place: each entry's device, the scope then
    entered for CUDA (the flags cleared) whatever the tensor's device."""
    calls = []
    real = _numerics.true_f32

    @contextlib.contextmanager
    def record(device):
        calls.append(torch.device(device).type)
        with real(CUDA):
            assert _flags() == (False, False)
            yield

    monkeypatch.setattr(_numerics, "true_f32", record)
    return calls


def _wave(samples=16000, batch=2):
    return torch.from_numpy(np.random.default_rng(0).normal(scale=0.1, size=(batch, 1, samples))
                            .astype(np.float32))


def test_sinc_conv_enters_the_scope(entered):
    sinc = SincConv()
    x = _wave()
    with torch.no_grad():
        y = sinc(x)
    assert entered == ["cpu"]
    assert _flags() == (True, False)
    with torch.no_grad():
        want = torch.nn.functional.conv1d(x, sinc.filters()[:, None, :], stride=sinc.stride)
    assert torch.equal(y, want)


@pytest.mark.parametrize("dtype,scopes", [(torch.float32, 3), (torch.bfloat16, 1)])
def test_sincnet_enters_the_scope_on_its_f32_convolutions(entered, dtype, scopes):
    """The sinc filterbank always (it is f32), the two k=5 convolutions
    only at ``compute_dtype=float32``."""
    with torch.no_grad():
        out = SincNet(compute_dtype=dtype)(_wave())
    assert entered == ["cpu"] * scopes
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("kernel", [3, (3, 3)], ids=["1d", "2d"])
def test_quantizable_conv_enters_the_scope_on_its_f32_route(entered, kernel):
    rng = np.random.default_rng(1)
    dims = 1 if isinstance(kernel, int) else 2
    x = torch.from_numpy(rng.normal(size=(2, 8) + (12,) * dims).astype(np.float32))

    def conv(dtype, quantizable=True):
        m = QuantizableConv(8, 4, kernel, compute_dtype=dtype, quantizable=quantizable)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(rng.normal(size=m.weight.shape).astype(np.float32)))
        return m

    with torch.no_grad():
        conv(torch.float32)(x)
        assert entered == ["cpu"]
        conv(torch.bfloat16)(x)
        assert entered == ["cpu"]
        with precision.use(precision.Precision(int8_trunk=True)):
            conv(torch.float32)(x)  # the int8 route: no f32 convolution
            assert entered == ["cpu"]
            conv(torch.float32, quantizable=False)(x)  # a plain site under the switch
    assert entered == ["cpu", "cpu"]
    assert _flags() == (True, False)
