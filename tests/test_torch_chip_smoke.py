"""``chip_smoke.py``'s model-phase rule on the CPU: the kernels' logits
against the plain reference, where a top-1 flip passes only as a
near-tie under the fixed ``NEAR_TIE_LOGITS`` bound, with no allowance
on the number of flips and no bound that grows with the logits'
difference. The script itself needs a card; only its pure helper runs
here (loaded from its file, so nothing of it runs at import)."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

BOUND = chip_smoke.NEAR_TIE_LOGITS


def _logits(positions=8, vocab=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    # Top-1 at token 0 by a clear margin of 4 logits everywhere.
    ref = torch.rand((positions, vocab), generator=gen)
    ref[:, 0] = 5.0
    return ref


def test_equal_logits_pass_without_flips():
    ref = _logits()
    c = chip_smoke.compare_logits(ref.clone(), ref)
    assert c["ok"] and c["flips"] == 0 and c["diff"] == 0.0
    assert c["positions"] == 8 and c["margins"] == []


@pytest.mark.parametrize("margin,ok", [(BOUND / 2, True),
                                       (BOUND * 0.99, True),
                                       (BOUND, False), (BOUND * 2, False)])
def test_a_flip_passes_only_under_the_fixed_bound(margin, ok):
    ref = _logits()
    ref[3, 7] = 5.0 - margin  # the reference's runner-up at position 3
    got = ref.clone()
    got[3, 7] = 5.0 + 1e-3  # the kernels pick it
    c = chip_smoke.compare_logits(got, ref)
    assert c["flips"] == 1
    assert c["margins"] == pytest.approx([margin], abs=1e-6)
    assert c["ok"] is ok


def test_many_near_tie_flips_pass_with_no_count_allowance():
    """Every position flips on a near-tie: no share of positions is
    refused for being many."""
    ref = _logits()
    ref[:, 1] = 5.0 - BOUND / 4
    got = ref.clone()
    got[:, 1] = 5.0 + 1e-3
    c = chip_smoke.compare_logits(got, ref)
    assert c["ok"] and c["flips"] == 8


def test_a_larger_difference_does_not_excuse_a_larger_flip():
    """A flip past the bound fails even where the logits moved by more
    than the margin everywhere (the old rule allowed 2 * diff)."""
    ref = _logits() * 10  # top-1 at 50: 5% of it is 2.5 logits
    ref[2, 5] = 50.0 - 3 * BOUND
    got = ref + 4 * BOUND  # every logit moved by more than the margin
    got[2, 5] = got[2, 0] + 1e-3
    c = chip_smoke.compare_logits(got, ref)
    assert c["diff"] <= 0.05 * c["scale"]  # within the 5% rule
    assert c["diff"] > c["margins"][0] / 2  # the old rule let it pass
    assert not c["ok"]


def test_margin_is_measured_at_the_kernels_pick():
    """The margin is the reference's best minus its logit at the token
    the kernels picked, not at its own runner-up."""
    ref = _logits()
    ref[0, 2] = 5.0 - BOUND / 2  # the reference's runner-up, a near-tie
    ref[0, 9] = 5.0 - 2 * BOUND  # the kernels' pick is further down
    got = ref.clone()
    got[0, 9] = 6.0
    c = chip_smoke.compare_logits(got, ref)
    assert c["margins"] == pytest.approx([2 * BOUND], abs=1e-6)
    assert not c["ok"]


@pytest.mark.parametrize("bad", ["nan", "far"])
def test_non_finite_or_distant_logits_fail(bad):
    ref = _logits()
    got = ref.clone()
    if bad == "nan":
        got[1, 1] = float("nan")
    else:
        got[1, 1] += 0.06 * ref.abs().max()
    assert not chip_smoke.compare_logits(got, ref)["ok"]


# The fleet phase's stream rule: where a resumed or preempted stream
# first parts from its reference, the reference's margin against the
# token it got is its best logprob minus its logprob of that token.


def test_stream_margin_is_never_negative():
    """A reference that prefers the other token by 5 logits gives a
    margin of 5, not -5: the flip fails the near-tie bound."""
    tops = {10: -0.1, 11: -5.1, 12: -7.0}
    assert chip_smoke.tie_margin(tops, 11) == pytest.approx(5.0)
    assert chip_smoke.tie_margin(tops, 11) >= BOUND


@pytest.mark.parametrize("gap,ok", [(0.0, True), (BOUND / 2, True),
                                    (BOUND, False), (2.0, False)])
def test_stream_margin_against_the_fixed_bound(gap, ok):
    tops = {3: -0.5, 4: -0.5 - gap, 5: -9.0}
    margin = chip_smoke.tie_margin(tops, 4)
    assert margin == pytest.approx(gap)
    assert (margin < BOUND) is ok


def test_stream_margin_outside_the_top_is_infinite():
    """A token that is not among the reference's top logprobs has no
    measured margin: it never passes as a near tie."""
    assert chip_smoke.tie_margin({3: -0.5, 4: -0.6}, 9) == float("inf")


# ---- the script's exit: a failed phase fails the run ------------------------

_RUN_WITH_PHASES = r"""
import collections, importlib.util, sys, types
import torch
torch.cuda.is_available = lambda: True
torch.cuda.get_device_name = lambda *a: "stand-in card"
torch.cuda.device_count = lambda: 1
torch.cuda.empty_cache = lambda: None
import subprocess
subprocess.run = lambda *a, **k: types.SimpleNamespace(
    stdout="stand-in card, 700.00 W\n", returncode=0)
from production_stack_tpu_torch.ops import paged_kv_common
paged_kv_common.build_kernels = lambda log=None: "kernels.so"
paged_kv_common.kernel_lib = lambda: None
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
failing = sys.argv[2]
for name in list(vars(smoke)):
    if name.endswith("_phase") and callable(getattr(smoke, name)):
        if name == failing:
            def fail(*args):
                raise AssertionError("this phase failed")
            setattr(smoke, name, fail)
        else:
            setattr(smoke, name,
                    lambda *args: collections.defaultdict(dict))
sys.argv = sys.argv[:1]
sys.exit(smoke.main())
"""

PHASES_RUN_BY_MAIN = ["kernel_phase", "model_phase", "engine_phase",
                      "graph_phase", "sampling_options_phase",
                      "serving_phase", "fleet_phase", "disagg_phase",
                      "autotune_phase", "weights_phase", "families_phase",
                      "geometries_phase", "pages_phase", "tp_phase",
                      "parallel2_phase",
                      "distributed_phase", "training_phase"]


@pytest.mark.parametrize("failing", PHASES_RUN_BY_MAIN)
def test_a_failing_phase_exits_non_zero_without_result_lines(tmp_path,
                                                             failing):
    """main() runs every phase with no ``try`` around it: a phase that
    raises ends the run with a non-zero exit and no ``kernels`` or
    ``ok`` line (every other phase stubbed, the card faked)."""
    import subprocess
    import sys
    root = Path(__file__).resolve().parents[1]
    script = tmp_path / "run.py"
    script.write_text(_RUN_WITH_PHASES)
    proc = subprocess.run(
        [sys.executable, str(script), str(root / "chip_smoke.py"), failing],
        capture_output=True, text=True, cwd=root, timeout=120,
        env={**__import__("os").environ, "PYTHONPATH": str(root)})
    assert proc.returncode != 0
    assert "this phase failed" in proc.stderr
    assert '"ok": true' not in proc.stdout
    assert '"kernels"' not in proc.stdout


def test_the_script_alone_exits_non_zero(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo (and here, with no card), the script fails and prints no
    result line."""
    import shutil
    import subprocess
    import sys
    root = Path(__file__).resolve().parents[1]
    shutil.copy(root / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, cwd=tmp_path,
                          timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# ---- the kernels line -------------------------------------------------------


def _case(name, ms):
    return {"case": name, "max_abs_err": 1e-3, "ms": ms, "plain_ms": 5.0,
            "bound_ms": ms / 3, "bound_by": "bytes", "library_ms": 0.1}


def test_kernels_line_carries_the_new_geometries():
    """Each attention kernel's entry has the contract's keys, its four
    forms and a ``geometries`` object keyed ``g4_d128`` and ``g1_d64``
    with the same numbers, the launches of that geometry's serving run
    and ``int8``; ``launches_by_run`` names the families' runs; the
    int8-weight GEMM carries OPT-1.3b's and GPT-2's projections."""
    forms = ("bf16", "int8", "stacked", "int8_stacked")
    headline = {k: {f: _case(f"{k} {f}", 0.1) for f in forms}
                for k in chip_smoke.KERNELS}
    runs = (chip_smoke.MAIN_RUN, chip_smoke.INT8_RUN,
            chip_smoke.STACKED_RUN, chip_smoke.BURST_RUN,
            chip_smoke.FLEET_RUN, chip_smoke.FLEET_INT8_RUN,
            chip_smoke.DISAGG_RUN, chip_smoke.DISAGG_INT8_RUN,
            chip_smoke.WEIGHTS_RUN, chip_smoke.MIXTRAL_RUN,
            chip_smoke.OPT_RUN, chip_smoke.GPT2_RUN)
    launches = {run: {k: i + 1 for k in chip_smoke.KERNELS}
                for i, run in enumerate(runs)}
    launches[chip_smoke.WEIGHTS_RUN]["int8_weight_matmul"] = 64
    weights = {"headline": dict(_case("w8", 0.03), dequant_ms=0.09)}
    families = {
        "geometries": {k: {g: {"bf16": _case(f"{k} {g}", 0.2),
                               "int8": _case(f"{k} {g} int8", 0.3)}
                           for g in chip_smoke.FAMILY_GEOMETRIES}
                       for k in chip_smoke.KERNELS},
        "w8": {"opt-1.3b fc1": dict(_case("opt fc1", 0.04),
                                    dequant_ms=0.1),
               "gpt2 fc1": dict(_case("gpt2 fc1", 0.02), dequant_ms=0.05)}}
    line = chip_smoke.kernels_line(headline, launches, weights, families)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [e["name"] for e in line] == list(chip_smoke.KERNELS) + [
        "int8_weight_matmul"]
    for entry in line:
        assert keys <= set(entry)
    for entry in line[:3]:
        geos = entry["geometries"]
        assert sorted(geos) == ["g1_d64", "g4_d128"]
        assert geos["g4_d128"]["launches"] == launches[
            chip_smoke.MIXTRAL_RUN][entry["name"]]
        assert geos["g1_d64"]["launches"] == launches[
            chip_smoke.OPT_RUN][entry["name"]]
        for geo in geos.values():
            assert {"ms", "bound_ms", "bound_by", "library_ms", "plain_ms",
                    "max_abs_err"} <= set(geo) <= set(geo) | {"int8"}
            assert geo["int8"]["ms"] == 0.3
        assert {chip_smoke.MIXTRAL_RUN, chip_smoke.OPT_RUN,
                chip_smoke.GPT2_RUN} <= set(entry["launches_by_run"])
        assert entry["launches"] == launches[chip_smoke.MAIN_RUN][
            entry["name"]]
    assert sorted(line[3]["families"]) == ["gpt2 fc1", "opt-1.3b fc1"]
    assert line[3]["launches"] == 64


def test_kernels_line_carries_the_tail_form():
    """With the tp phase's results the line gains the decode kernel's
    burst-tail form: the contract's keys, its four forms and
    ``g4_d128``, each beside the non-tail form's time, its launches
    those of the deferred server's window."""
    forms = ("bf16", "int8", "stacked", "int8_stacked")
    headline = {k: {f: _case(f"{k} {f}", 0.1) for f in forms}
                for k in chip_smoke.KERNELS}
    runs = (chip_smoke.MAIN_RUN, chip_smoke.INT8_RUN,
            chip_smoke.STACKED_RUN, chip_smoke.BURST_RUN,
            chip_smoke.WEIGHTS_RUN, chip_smoke.MIXTRAL_RUN,
            chip_smoke.OPT_RUN, chip_smoke.DEFERRED_RUN)
    launches = {run: {k: 1 for k in chip_smoke.KERNELS} for run in runs}
    launches[chip_smoke.DEFERRED_RUN]["paged_decode_tail"] = 40
    for i, (form, _) in enumerate(chip_smoke.DEFERRED_FORMS):
        launches[f"{chip_smoke.DEFERRED_RUN}_{form}"] = {
            f"paged_decode_tail_{form}": 10 + i}
    weights = {"headline": dict(_case("w8", 0.03), dequant_ms=0.09)}
    families = {
        "geometries": {k: {g: {"bf16": _case(f"{k} {g}", 0.2),
                               "int8": _case(f"{k} {g} int8", 0.3)}
                           for g in chip_smoke.FAMILY_GEOMETRIES}
                       for k in chip_smoke.KERNELS},
        "w8": {}}
    cases = {geo: {f: dict(_case(f"tail {geo} {f}", 0.05), decode_ms=0.04)
                   for f in forms} for geo in ("bench_1b", "g4_d128")}
    line = chip_smoke.kernels_line(headline, launches, weights, families,
                                   {"cases": cases})
    tail = line[-1]
    assert tail["name"] == "paged_decode_tail"
    assert {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "decode_ms"} <= set(tail)
    assert tail["launches"] == 40
    assert tail["launches_by_run"][chip_smoke.DEFERRED_RUN] == 40
    assert tail["launches_by_run"][chip_smoke.MAIN_RUN] == 0
    for i, form in enumerate(("int8", "stacked", "int8_stacked")):
        assert tail[form]["decode_ms"] == 0.04
        assert tail[form]["launches"] == 10 + i
    assert tail["geometries"]["g4_d128"]["int8"]["ms"] == 0.05
    assert tail["source"].endswith("csrc/paged_decode.cu")


def test_kernels_line_carries_the_geometries_rows():
    """With the geometries phase's results each attention kernel's
    ``geometries`` also holds ``g8_d128`` (with ``int8``), ``g1_d80``,
    ``g7_d64`` and ``g1_d128``: the contract's numbers, the row's dtype
    and the launches of the run that served it (0 for g1_d128, which
    no run serves); the int8-weight GEMM gains its f16 form."""
    forms = ("bf16", "int8", "stacked", "int8_stacked")
    headline = {k: {f: _case(f"{k} {f}", 0.1) for f in forms}
                for k in chip_smoke.KERNELS}
    runs = (chip_smoke.MAIN_RUN, chip_smoke.INT8_RUN,
            chip_smoke.STACKED_RUN, chip_smoke.BURST_RUN,
            chip_smoke.WEIGHTS_RUN, chip_smoke.MIXTRAL_RUN,
            chip_smoke.OPT_RUN, chip_smoke.LLAMA70_RUN, chip_smoke.OPT27_RUN,
            chip_smoke.QWEN05_RUN)
    launches = {run: {k: 7 for k in chip_smoke.KERNELS} for run in runs}
    launches[chip_smoke.LLAMA70_INT8_RUN] = {
        k + "_int8": 9 for k in chip_smoke.KERNELS}
    launches[chip_smoke.D512_RUN] = {k: 3 for k in chip_smoke.KERNELS}
    launches[chip_smoke.D512_INT8_RUN] = {
        k + "_int8": 5 for k in chip_smoke.KERNELS}
    launches[chip_smoke.W8_F16_RUN] = {"int8_weight_matmul": 64}
    weights = {"headline": dict(_case("w8", 0.03), dequant_ms=0.09)}
    families = {
        "geometries": {k: {g: {"bf16": _case(f"{k} {g}", 0.2),
                               "int8": _case(f"{k} {g} int8", 0.3)}
                           for g in chip_smoke.FAMILY_GEOMETRIES}
                       for k in chip_smoke.KERNELS},
        "w8": {}}
    rows = {k: {"g8_d128": {"bfloat16": _case("a", 0.4),
                            "int8": _case("b", 0.5)},
                "g1_d80": {"float16": _case("c", 0.6)},
                "g7_d64": {"float32": _case("d", 0.7)},
                "g1_d128": {"bfloat16": _case("e", 0.8)},
                "g3_d512": {"bfloat16": _case("g", 0.9),
                            "int8": _case("h", 1.0)},
                "g1_d320": {"float16": _case("i", 1.1)}}
            for k in chip_smoke.KERNELS}
    geometries = {"rows": rows,
                  "w8": {"fc1": dict(_case("f16 fc1", 0.05),
                                     dequant_ms=0.1)}}
    line = chip_smoke.kernels_line(headline, launches, weights, families,
                                   geometries=geometries)
    for entry in line[:3]:
        geos = entry["geometries"]
        assert sorted(geos) == ["g1_d128", "g1_d320", "g1_d64", "g1_d80",
                                "g3_d512", "g4_d128", "g7_d64", "g8_d128"]
        assert geos["g3_d512"]["launches"] == 3
        assert geos["g3_d512"]["int8"]["launches"] == 5
        assert geos["g1_d320"]["launches"] == 0
        assert entry["launches_by_run"][chip_smoke.D512_INT8_RUN] == 5
        assert geos["g8_d128"]["ms"] == 0.4
        assert geos["g8_d128"]["dtype"] == "bfloat16"
        assert geos["g8_d128"]["launches"] == 7
        assert geos["g8_d128"]["int8"]["ms"] == 0.5
        assert geos["g8_d128"]["int8"]["launches"] == 9
        assert geos["g1_d80"]["dtype"] == "float16"
        assert geos["g7_d64"]["launches"] == 7
        assert geos["g1_d128"]["launches"] == 0
        assert {"ms", "bound_ms", "bound_by", "library_ms", "plain_ms",
                "max_abs_err"} <= set(geos["g1_d80"])
        assert entry["launches_by_run"][chip_smoke.LLAMA70_INT8_RUN] == 9
    assert line[3]["f16"]["launches"] == 64
    assert line[3]["f16"]["opt-2.7b"]["fc1"]["ms"] == 0.05


def test_kernels_line_carries_the_pages_rows():
    """With the pages phase's results each attention kernel's ``pages``
    holds its rows at pages 128, 16, 256 and 8: the contract's numbers,
    ``int8`` beside bf16, the launches of the run that served that page
    and cache (0 at page 16, which no run serves), the prefill kernel's
    second chunk; the pages servers appear in ``launches_by_run``."""
    forms = ("bf16", "int8", "stacked", "int8_stacked")
    headline = {k: {f: _case(f"{k} {f}", 0.1) for f in forms}
                for k in chip_smoke.KERNELS}
    runs = (chip_smoke.MAIN_RUN, chip_smoke.STACKED_RUN,
            chip_smoke.BURST_RUN, chip_smoke.WEIGHTS_RUN,
            chip_smoke.MIXTRAL_RUN, chip_smoke.OPT_RUN,
            chip_smoke.PAGES_256_RUN)
    launches = {run: {k: 7 for k in chip_smoke.KERNELS} for run in runs}
    launches[chip_smoke.INT8_RUN] = {k + "_int8": 5
                                     for k in chip_smoke.KERNELS}
    launches[chip_smoke.PAGES_INT8_RUN] = {
        k + "_int8_stacked": 9 for k in chip_smoke.KERNELS}
    weights = {"headline": dict(_case("w8", 0.03), dequant_ms=0.09)}
    families = {
        "geometries": {k: {g: {"bf16": _case(f"{k} {g}", 0.2),
                               "int8": _case(f"{k} {g} int8", 0.3)}
                           for g in chip_smoke.FAMILY_GEOMETRIES}
                       for k in chip_smoke.KERNELS},
        "w8": {}}

    def page_rows(kernel):
        rows = {f"ps{ps}": {"bf16": _case("a", 0.4), "int8": _case("b", 0.5)}
                for ps in (128, 16, 256)}
        rows["ps8"] = {"int8": _case("c", 0.6)}
        return rows

    rows = {k: page_rows(k) for k in list(chip_smoke.KERNELS)
            + ["paged_prefill_second"]}
    line = chip_smoke.kernels_line(headline, launches, weights, families,
                                   pages={"rows": rows})
    for entry in line[:3]:
        pages = entry["pages"]
        assert sorted(pages) == ["ps128", "ps16", "ps256", "ps8"]
        assert pages["ps128"]["ms"] == 0.4
        assert pages["ps128"]["launches"] == 7
        assert pages["ps128"]["int8"]["launches"] == 5
        assert pages["ps16"]["launches"] == 0
        assert pages["ps256"]["launches"] == 7
        assert pages["ps8"]["int8"]["ms"] == 0.6
        assert pages["ps8"]["int8"]["launches"] == 9
        assert {"ms", "bound_ms", "bound_by", "library_ms", "plain_ms",
                "max_abs_err"} <= set(pages["ps16"]["int8"])
        assert entry["launches_by_run"][chip_smoke.PAGES_INT8_RUN] == 9
        assert entry["launches_by_run"][chip_smoke.PAGES_256_RUN] == 7
        assert ("second_chunk" in pages["ps16"]) == (
            entry["name"] == "paged_prefill")


def test_bound_takes_the_f32_fma_peak():
    """An f32 case's operations are bounded at the FMA units' rate, a
    16-bit one's at the tensor cores'."""
    flops = int(67e9)
    f32 = chip_smoke._bound(0, flops, torch.float32)
    f16 = chip_smoke._bound(0, flops, torch.float16)
    assert f32["bound_ms"] == pytest.approx(1.0)
    assert f16["bound_ms"] == pytest.approx(67 / 989)
    assert f32["bound_by"] == "operations"


@pytest.mark.parametrize("source,counter", [
    ("paged_prefill.cuh", "paged_prefill"),
    ("paged_ragged.cuh", "paged_ragged")])
def test_profiled_kernel_names_map_to_their_counters(source, counter):
    """The graph and observatory phases count the kernels the profiler
    saw by their counters: every __global__ of the prefill and ragged
    sources (the wgmma walk, the mma.sync and slab walks, the f32 walk)
    maps to its kernel's counter; the decode merge maps to none."""
    src = (Path(__file__).resolve().parents[1] / "production_stack_tpu_torch"
           / "csrc" / source).read_text()
    names = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert names
    for name in names:
        demangled = f"void pstt::(anonymous namespace)::{name}<float>(...)"
        assert chip_smoke._kernel_family(demangled) == counter, name
    assert chip_smoke._kernel_family(
        "void pstt::(anonymous namespace)::paged_decode_merge_kernel"
        "<float, 64, 1>(...)") is None
