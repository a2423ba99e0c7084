"""bench.py's peak table: keyed by device_kind, an unknown device is an error."""

import pytest

import bench


def test_peak_table_knows_the_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_flops"] == 989e12 and peaks["hbm_bytes_per_s"] == 3.35e12
    assert "H100" in peaks["source"]


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="No published peak"):
        bench.device_peaks(kind)


def test_this_process_device_is_not_assumed():
    """On the CPU test host the first device has no peak: nothing defaults."""
    with pytest.raises(KeyError):
        bench.device_peaks()
