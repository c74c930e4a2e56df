"""PyTorch port, the profiling tools (`utils/profiling.py`,
`scripts/profiler.py`, `scripts/analyze_trace.py`) on the CPU.

The analyzer on a synthetic Chrome trace in torch.profiler's format: device
events (kernels, copies, sets) mixed with CPU events (`cpu_op`,
`cuda_runtime`, `python_function`) and `record_function` ranges on both
timelines, kernel names with template arguments, argument lists and
numeric suffixes.  Its totals, counts and shares are exact; only device
events count; clones merge as the JAX analyzer's `strip_suffix` merges
them.  Then a `--tiny --cpu` profiler run, whose trace holds CPU events
only, on which the analyzer stops with the JAX analyzer's message.
"""
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from diffusion_spacetime_attn_tpu_torch.scripts import analyze_trace, profiler
from diffusion_spacetime_attn_tpu_torch.utils import profiling

FLASH = ("void (anonymous namespace)::flash_fwd_wgmma_kernel<40>(CUtensorMap, CUtensorMap, "
         "CUtensorMap, __nv_bfloat16*, float*, int, int, int, float)")
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"
EVENTS = [
    {"ph": "X", "cat": "kernel", "name": FLASH, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": FLASH.replace("<40>", "<80>"), "dur": 50},
    {"ph": "X", "cat": "kernel", "name": GEMM + "_execute_segment_k_off_kernel", "dur": 30},
    {"ph": "X", "cat": "kernel", "name": "geglu_gate_wgmma_kernel", "dur": 12},
    {"ph": "X", "cat": "kernel", "name": "geglu_gate_wgmma_kernel", "dur": 8},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "dur": 5},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 3},
    {"ph": "X", "cat": "kernel", "name": "fusion.12", "dur": 2},
    {"ph": "X", "cat": "kernel", "name": "fusion.3", "dur": 0},
    # CPU side and ranges: never counted
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 1000},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 700},
    {"ph": "X", "cat": "python_function", "name": "torch/nn/modules/module.py(1)", "dur": 900},
    {"ph": "X", "cat": "user_annotation", "name": "mha_bwd_plain", "dur": 400},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "mha_bwd_plain", "dur": 300},
    {"ph": "i", "cat": "kernel", "name": "instant", "dur": 999},
    {"ph": "f", "cat": "ac2g", "name": "flow", "id": 1},
]


def _trace_dir(tmp_path, events=EVENTS):
    d = tmp_path / "trace"
    d.mkdir()
    (d / "host_1.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    return d


def _json_table(*argv):
    out = io.StringIO()
    with redirect_stdout(out):
        analyze_trace.main(list(argv) + ["--json"])
    return {row["op"]: row for row in json.loads(out.getvalue())}


def test_analyzer_sums_device_events_only_and_merges_clones(tmp_path):
    rows = _json_table("--trace-dir", str(_trace_dir(tmp_path)), "--top", "50")
    total = 100 + 50 + 30 + 12 + 8 + 5 + 3 + 2 + 0
    assert rows == {
        "flash_fwd_wgmma_kernel": {"op": "flash_fwd_wgmma_kernel", "family": "flash_fwd",
                                   "total_ms": 0.15, "count": 2, "share": 150 / total},
        GEMM + "_execute_segment_k_off_kernel": {
            "op": GEMM + "_execute_segment_k_off_kernel", "family": "matmul",
            "total_ms": 0.03, "count": 1, "share": 30 / total},
        "geglu_gate_wgmma_kernel": {"op": "geglu_gate_wgmma_kernel", "family": "geglu_fwd",
                                    "total_ms": 0.02, "count": 2, "share": 20 / total},
        "Memcpy HtoD (Pageable -> Device)": {
            "op": "Memcpy HtoD (Pageable -> Device)", "family": "other", "total_ms": 0.005,
            "count": 1, "share": 5 / total},
        "Memset (Device)": {"op": "Memset (Device)", "family": "other", "total_ms": 0.003,
                            "count": 1, "share": 3 / total},
        "fusion": {"op": "fusion", "family": "other", "total_ms": 0.002, "count": 2,
                   "share": 2 / total},
    }
    assert sum(r["share"] for r in rows.values()) == pytest.approx(1.0, abs=1e-15)


def test_analyzer_raw_keeps_clones_and_top_cuts(tmp_path):
    d = str(_trace_dir(tmp_path))
    raw = _json_table("--trace-dir", d, "--raw", "--top", "50")
    assert raw[FLASH]["count"] == 1 and raw[FLASH]["total_ms"] == 0.1
    assert "fusion.12" in raw and "fusion.3" in raw and len(raw) == 8
    assert list(_json_table("--trace-dir", d, "--top", "1")) == ["flash_fwd_wgmma_kernel"]


def test_analyzer_table_and_per_step(tmp_path, capsys):
    analyze_trace.main(["--trace-dir", str(_trace_dir(tmp_path)), "--per-step", "5",
                        "--iters", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "# total device time: 0.2 ms"
    flash = next(line for line in out if line.startswith("flash_fwd_wgmma_kernel"))
    assert flash.split()[1:] == ["flash_fwd", "0.15", "2", "71.4%", "0.015"]


@pytest.mark.parametrize("name,merged", [
    (FLASH, "flash_fwd_wgmma_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "at::native::vectorized_elementwise_kernel"),
    ("mha_fwd_mma_kernel<5>", "mha_fwd_mma_kernel"),
    ("convolution.7", "convolution"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD (Device -> Device)"),
])
def test_strip_suffix_merges_template_and_numeric_clones(name, merged):
    assert analyze_trace.strip_suffix(name) == merged


def test_analyzer_without_trace_or_device_events_exits(tmp_path):
    with pytest.raises(SystemExit, match="no trace files under"):
        analyze_trace.main(["--trace-dir", str(tmp_path)])
    cpu_only = [e for e in EVENTS if e["cat"] not in analyze_trace.DEVICE_CATEGORIES]
    with pytest.raises(SystemExit, match="no device events found in the trace"):
        analyze_trace.main(["--trace-dir", str(_trace_dir(tmp_path, cpu_only))])
    with pytest.raises(NotImplementedError, match="--hlo"):
        analyze_trace.main(["--trace-dir", str(tmp_path), "--hlo", "x.txt"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode,remat", [("vanilla", "true"), ("spacetime", "dots_nb")])
def test_tiny_cpu_profiler_writes_a_trace_the_analyzer_finds_no_device_events_in(
        tmp_path, mode, remat):
    d = tmp_path / "prof"
    line = profiler.main(["--tiny", "--cpu", "--mode", mode, "--steps", "2", "--batch", "1",
                          "--iters", "1", "--trace-dir", str(d), "--remat", remat])
    events = analyze_trace.load_events(line["trace"])
    assert analyze_trace.find_trace_files(str(d)) == [line["trace"]]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert line["device"] == "cpu" and set(line["launches"].values()) == {0}
    with pytest.raises(SystemExit, match="no device events found in the trace"):
        analyze_trace.main(["--trace-dir", str(d)])


def test_profiler_refuses_hlo_out_and_needs_a_card_without_cpu(tmp_path):
    with pytest.raises(NotImplementedError, match="--hlo-out"):
        profiler.main(["--tiny", "--cpu", "--hlo-out", str(tmp_path / "h.txt")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiler.main(["--tiny", "--trace-dir", str(tmp_path)])


def test_profiling_helpers(tmp_path):
    lines = []
    with profiling.timed("span", lines.append):
        pass
    assert len(lines) == 1 and lines[0].startswith("[timed] span: ")
    with profiling.trace(str(tmp_path)) as path:
        with profiling.annotate("my_span"):
            torch.ones(3) + 1
    names = {e.get("name") for e in analyze_trace.load_events(path)
             if e.get("cat") == "user_annotation"}
    assert "my_span" in names
    log = profiling.get_logger("dsta_test")
    assert profiling.get_logger("dsta_test") is log and len(log.handlers) == 1
    assert [profiling.kernel_family(n) for n in (
        "spacetime_bwd_dq_wgmma_kernel", "geglu_dx_out_wgmma_kernel", "sum_slices_kernel",
        "cudnn::engines_precompiled::nchwToNhwcKernel", "nvjet_tst_128x64", "softmax_warp_forward",
        "multi_tensor_apply_kernel", "elementwise_kernel")] == [
        "spacetime_bwd", "geglu_bwd", "geglu_sum_slices", "convolution", "matmul", "softmax",
        "optimizer", "other"]
