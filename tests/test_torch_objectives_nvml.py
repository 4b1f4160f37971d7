"""The energy objective's NVML probe (``repro_torch.core.objectives``)
where ``pynvml`` is absent: board power read from NVML's
``libnvidia-ml.so.1`` through ``ctypes`` (here a stub library object that
answers as NVML's C API does), ``None`` on a host without the library or
when a call fails, probed once a process."""
import ctypes

import pytest

pytest.importorskip("torch")

from repro_torch.core import objectives  # noqa: E402


class StubNVML:
    """NVML's three calls, each returning 0 (NVML_SUCCESS) or ``fail``;
    the power call writes ``milliwatts``."""

    def __init__(self, milliwatts: int, fail: str = ""):
        self.milliwatts = milliwatts
        self.fail = fail
        self.calls = []

        def call(name, body=None):
            def fn(*args):
                self.calls.append(name)
                if name == self.fail:
                    return 999
                if body is not None:
                    body(*args)
                return 0
            return fn

        def handle(index, out):
            out.contents.value = 0x1234

        def power(handle, out):
            assert handle.value == 0x1234
            out.contents.value = self.milliwatts

        self.nvmlInit_v2 = call("init")
        self.nvmlDeviceGetHandleByIndex_v2 = call("handle", handle)
        self.nvmlDeviceGetPowerUsage = call("power", power)
        self.nvmlShutdown = call("shutdown")


@pytest.fixture
def fresh_probe(monkeypatch):
    monkeypatch.setattr(objectives, "_nvml_probed", False)
    monkeypatch.setattr(objectives, "_nvml_watts", None)


def test_ctypes_probe_reads_milliwatts_as_watts(fresh_probe, monkeypatch):
    lib = StubNVML(70536)
    monkeypatch.setattr(objectives, "_load_nvml", lambda: lib)
    assert objectives.nvml_power_w() == pytest.approx(70.536)
    assert lib.calls == ["init", "handle", "power", "shutdown"]
    assert lib.nvmlDeviceGetPowerUsage.argtypes[1] == ctypes.POINTER(
        ctypes.c_uint)
    lib.milliwatts = 1                     # probed once a process
    assert objectives.nvml_power_w() == pytest.approx(70.536)
    assert lib.calls.count("power") == 1


@pytest.mark.parametrize("fail", ["init", "handle", "power"])
def test_ctypes_probe_is_none_when_a_call_fails(fresh_probe, monkeypatch,
                                                fail):
    lib = StubNVML(70536, fail=fail)
    monkeypatch.setattr(objectives, "_load_nvml", lambda: lib)
    assert objectives.nvml_power_w() is None
    assert ("shutdown" in lib.calls) == (fail != "init")


def test_probe_is_none_without_the_library(fresh_probe, monkeypatch):
    def missing(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", missing)
    assert objectives._load_nvml() is None
    assert objectives.nvml_power_w() is None
