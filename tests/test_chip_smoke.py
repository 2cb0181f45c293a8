"""The chip smoke's own checks that run without a card: it must refuse
anything but GPUs, and its readers of compiled HLO must parse."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ambigram_tpu.utils.device import describe_devices, require_gpu  # noqa: E402


def test_smoke_device_check_rejects_cpu():
    import jax

    with pytest.raises(RuntimeError, match="GPU is required"):
        chip_smoke.phase_device(jax.devices())


def test_require_gpu_rejects_no_devices():
    with pytest.raises(RuntimeError, match="no devices"):
        require_gpu([])


def test_describe_devices_names_the_cpu_mesh():
    d = describe_devices()
    assert (d["platform"], d["kind"], d["count"]) == ("cpu", "cpu", 8)
    assert d["nvidia_smi"]


def test_dot_lowering_reads_gemm_calls_and_plain_dots():
    hlo = (
        '%c = f32[4,8] custom-call(%a, %b), custom_call_target="__cublas$gemm"\n'
        "%d = s32[4,8] dot(%x, %y), lhs_contracting_dims={1}\n"
    )
    text = chip_smoke.dot_lowering(hlo)
    assert "__cublas$gemm" in text and "plain_dots=1" in text
