"""The port's peak table and its ``CME213_DEVICE_PEAKS`` override
(``cme213_tpu_torch/core/roofline.py``), against the JAX package's.

Ports the override cases of ``tests/test_perf_observability.py`` with the
port's H100 entries in place of the TPU ones: an override of ``h100-sxm``
changes ``pct_peak`` for the SXM card's name, an exact-name override wins
over the H100 rule, malformed entries are ignored, ``attribute`` returns
the normalised device name, and a span's roofline attribution reads the
override.  ``test_sweep_rows_carry_pct_peak_and_bound`` holds each row's
``gbs`` and ``pct_peak`` to what the row's ``ms`` and the cost model
allow, given the ``ms`` column's rounding, so a slow run cannot round a
column to 0 and fail it.
"""

import pytest
import torch

from cme213_tpu.core import roofline as jroofline
from cme213_tpu_torch.core import roofline, trace
from cme213_tpu_torch.core.trace import span

SXM = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(roofline.DEVICE_PEAKS_ENV, raising=False)
    trace.clear_events()
    yield
    trace.clear_events()


def test_variable_is_the_reference_s():
    assert roofline.DEVICE_PEAKS_ENV == jroofline.DEVICE_PEAKS_ENV \
        == "CME213_DEVICE_PEAKS"


@pytest.mark.parametrize("name", [SXM, "NVIDIA H100 PCIe", " TPU v5 lite ",
                                  "h100_sxm", "cpu", "Mystery Chip"])
def test_normalize_equals_reference(name):
    assert roofline.normalize(name) == jroofline.normalize(name)


def test_peak_registry_and_env_override(monkeypatch):
    assert roofline.PEAKS["h100-sxm"].gbs == 3350.0
    assert roofline.peak_for(SXM).name == "h100-sxm"
    assert roofline.peak_for("NVIDIA H100 PCIe").name == "h100-pcie"
    assert roofline.peak_for("mystery-chip") is None
    assert roofline.peak_for("cpu") is None  # no host entry in the port
    assert roofline.peak_for(None) is None and roofline.peak_for("") is None
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV,
                       "mystery-chip:123:456, h100-sxm:1675:33500, bad-entry")
    assert roofline.peak_for("mystery-chip").gbs == 123.0
    sxm = roofline.peak_for(SXM)  # the override wins
    assert (sxm.gbs, sxm.gfs_f32, sxm.gfs_f64) == (1675.0, 33500.0, 33500.0)
    assert roofline.peak_for("NVIDIA H100 PCIe").gbs == 2000.0
    assert "h100-sxm" in roofline.PEAKS and roofline.PEAKS[
        "h100-sxm"].gbs == 3350.0  # the table itself is untouched


def test_override_entries_match_reference(monkeypatch):
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV,
                       "Mystery Chip:123:456,h100_sxm:1675:33500")
    ours, ref = roofline.peaks(), jroofline.peaks()
    for key in ("mystery-chip", "h100-sxm"):
        assert (ours[key].name, ours[key].gbs, ours[key].gfs_f32) == \
            (ref[key].name, ref[key].gbs, ref[key].gfs)


def test_exact_name_override_wins_over_the_h100_rule(monkeypatch):
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV,
                       "nvidia-h100-80gb-hbm3:2000:1000")
    assert roofline.peak_for(SXM).gbs == 2000.0
    assert roofline.peak_for("NVIDIA H100 SXM5 80GB").gbs == 3350.0
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV,
                       "NVIDIA H100 80GB HBM3:2000:1000, h100-sxm:1:1")
    assert roofline.peak_for(SXM).gbs == 2000.0


@pytest.mark.parametrize("value", [
    "h100-sxm:fast:1", "h100-sxm:1675", "h100-sxm:1:2:3", ":::", ",,",
    "h100-sxm", "h100-sxm:1675:", " : : "])
def test_malformed_entries_are_ignored(monkeypatch, value):
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV,
                       f"{value},mystery:10:20")
    assert roofline.peak_for(SXM).gbs == 3350.0
    assert roofline.peak_for("mystery").gbs == 10.0
    assert roofline.attribute(1675.0, device=SXM)["pct_peak"] == 50.0


def test_attribute_pct_peak_and_bound(monkeypatch):
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV, "testdev:100:1000")
    att = roofline.attribute(10.0, 1.0, device="testdev")
    assert att["pct_peak"] == 10.0 and att["bound"] == "memory"
    assert roofline.attribute(1.0, 900.0, device="testdev")["bound"] == \
        "compute"
    assert roofline.attribute(10.0, device="nope")["pct_peak"] is None
    assert roofline.attribute(0.0, device="testdev")["pct_peak"] is None
    for gbs, gfs in ((10.0, 1.0), (1.0, 900.0)):
        ours = roofline.attribute(gbs, gfs, device="testdev")
        ref = jroofline.attribute(gbs, gfs, device="testdev")
        assert ours == ref


def test_override_changes_pct_peak_for_the_sxm_card(monkeypatch):
    att = roofline.attribute(1675.0, 100.0, device=SXM)
    assert att["pct_peak"] == 50.0 and att["peak_gbs"] == 3350.0
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV, "h100-sxm:1675:33500")
    att = roofline.attribute(1675.0, 100.0, device=SXM)
    assert att["pct_peak"] == 100.0 and att["peak_gbs"] == 1675.0
    assert att["peak_gfs"] == 33500.0 and att["bound"] == "memory"
    cost = roofline.heat_cost(4000, order=8, iters=1)
    ms, by = roofline.bound_ms(cost, roofline.peak_for(SXM), torch.float32)
    assert by == "bytes" and ms == pytest.approx(128e6 / 1675e9 * 1e3)


def test_attribute_returns_the_normalised_device_name(monkeypatch):
    att = roofline.attribute(1675.0, device=SXM)
    assert att["device"] == "nvidia-h100-80gb-hbm3" == \
        jroofline.attribute(1675.0, device=SXM)["device"]
    assert roofline.attribute(1.0, device="cpu")["device"] == "cpu"
    assert roofline.attribute(1.0, device="")["device"] == "unknown"
    monkeypatch.setattr(roofline, "detect_device", lambda: SXM)
    assert roofline.attribute(1.0)["device"] == "nvidia-h100-80gb-hbm3"


def test_span_roofline_attribution(monkeypatch):
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV, "testdev:100:1000")
    monkeypatch.setattr(roofline, "detect_device", lambda: "testdev")
    with span("op.run", kernel="k", shape_class="s") as sp:
        sp.roofline(1_000_000, 10_000)
    end = trace.events("span-end")[-1]
    assert end["achieved_gbs"] > 0
    assert end["pct_peak"] > 0 and end["bound"] == "memory"


def test_span_attribution_reads_the_override(monkeypatch):
    """The same span on the SXM card's name, with and without an override
    that halves the memory rate: the recorded share doubles."""
    monkeypatch.setattr(roofline, "detect_device", lambda: SXM)
    nbytes = 50_000_000_000
    shares = []
    for value in (None, "h100-sxm:1675:33500"):
        if value:
            monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV, value)
        with span("heat.run", kernel="pipeline") as sp:
            sp.roofline(nbytes, 0)
        end = trace.events("span-end")[-1]
        gbs = nbytes / 1e9 / (end["ms"] / 1e3)
        assert end["achieved_gbs"] == round(gbs, 3)
        shares.append((end["pct_peak"], round(100 * gbs / (
            1675.0 if value else 3350.0), 2)))
    for got, want in shares:
        assert got == want


def _within(value, lo, hi, slack):
    return lo - slack <= value <= hi + slack


def test_sweep_rows_carry_pct_peak_and_bound(monkeypatch):
    """Every sweep row carries pct_peak/bound from the one cost-model
    source of truth.  The row's ``ms`` is rounded to 0.01, so the true
    time lies within 0.005 ms of it: ``gbs`` (rounded to 0.01) and
    ``pct_peak`` (from the unrounded rate, rounded to 0.01) must lie in the
    range that interval implies."""
    monkeypatch.setenv(roofline.DEVICE_PEAKS_ENV, "cpu:40:400")
    from cme213_tpu_torch.bench.sweeps import heat_sweep, scan_sweep

    rows = heat_sweep(sizes=(32,), orders=(2,), iters=2, ks=(1,),
                      device="cpu")
    assert rows
    for r in rows:
        assert r["error"] == "" and r["bound"] == "memory"
        c = roofline.heat_cost(r["size"], order=r["order"],
                               iters=r["iters"], dtype=r["dtype"])
        fast = c.gbs(max(r["ms"] - 0.005, 1e-9))
        slow = c.gbs(r["ms"] + 0.005)
        assert _within(r["gbs"], slow, fast, 0.005)
        assert _within(r["pct_peak"], 100 * slow / 40.0, 100 * fast / 40.0,
                       0.005)
    rows = scan_sweep(n=1 << 10, num_segments=4, device="cpu")
    assert all("pct_peak" in r and "bound" in r for r in rows)
