"""The port's serving launcher (``python -m repro_torch.launch.serve``),
the twin of ``repro.launch.serve``, served at smoke size on the CPU: the
dense, paged and spatial engines and the disaggregated pairs, the SLA
and shedding flags, the trace and the metrics exposition. Without
``--device cpu`` it runs on ``cuda`` and raises without one."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
# Smoke shapes run as fast on one thread, and the other test workers
# keep the remaining cores.
torch.set_num_threads(1)

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

SMALL = ["--device", "cpu", "--requests", "3", "--prompt-len", "16",
         "--max-tokens", "5"]


@pytest.mark.parametrize("arch", ["olmo_1b", "chatglm3_6b", "olmoe_1b_7b"])
@pytest.mark.parametrize("mode", [["--engine", "dense"],
                                  ["--engine", "paged"], ["--disagg"]],
                         ids=["dense", "paged", "disagg"])
def test_launcher_serves(capsys, mode, arch):
    """Every request is served to its budget; the disaggregated pair runs,
    as the reference's does, on the router's default engine configs, whose
    EOS id (1) may end a request early."""
    rep = serve.main(["--arch", arch, *SMALL, *mode])
    toks = rep["tokens_by_request"]
    assert rep["requests"] == 3 and rep["tokens"] == sum(map(len, toks))
    for t in toks:
        assert all(0 <= x < 512 for x in t)
        assert len(t) == 5 or ("--disagg" in mode and t[-1] == 1)
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith(f"[serve] {arch} (smoke, ")
    assert "3 requests" in line and "cpu" in line
    if "--disagg" in mode:
        assert "transfers=" in line and "transfer_bytes=" in line


def test_launcher_sla_shedding_trace_and_metrics(capsys, tmp_path):
    trace = tmp_path / "run.json"
    prom = tmp_path / "run.prom"
    rep = serve.main(["--arch", "starcoder2_15b", *SMALL, "--sla-mix",
                      "--sla-deadlines", "--shed-watermarks", "8", "2",
                      "--trace", str(trace), "--metrics", str(prom)])
    assert set(rep["per_sla"]) == {"interactive", "standard", "batch"}
    assert json.loads(trace.read_text())["traceEvents"]
    assert "engine_ttft_seconds" in prom.read_text()
    out = capsys.readouterr().out
    assert "interactive=" in out and "metrics ->" in out


def test_launcher_without_telemetry_ignores_trace(capsys, tmp_path):
    serve.main(["--arch", "nemotron_4_340b", *SMALL, "--no-telemetry",
                "--trace", str(tmp_path / "t.json")])
    assert "--trace ignored" in capsys.readouterr().out
    assert not (tmp_path / "t.json").exists()


def test_launcher_cuts_depth(capsys):
    """Under ``--full`` Grok-1 keeps its published widths and takes its
    depth cut to 2 layers, its weights being beyond one card; OLMoE keeps
    its full depth, and smoke configs are served as they are (Grok-1's
    through the launcher)."""
    rep = serve.main(["--arch", "grok_1_314b", *SMALL])
    assert all(len(t) == 5 for t in rep["tokens_by_request"])
    assert capsys.readouterr().out.startswith(
        "[serve] grok_1_314b (smoke, paged, cpu): 3 requests")
    grok = serve.model_config("grok_1_314b", full=True)
    published = get_config("grok_1_314b")
    assert serve.FULL_DEPTH_CUT["grok_1_314b"] == 2
    assert grok.n_layers == 2 and published.n_layers == 64
    assert grok == dataclasses.replace(published, n_layers=2)
    assert serve.model_config("olmoe_1b_7b", full=True) \
        == get_config("olmoe_1b_7b")
    assert serve.model_config("grok_1_314b", full=False) \
        == get_smoke_config("grok_1_314b")


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "xlstm_125m"])
def test_launcher_serves_recurrent_families(capsys, arch):
    """``--engine dense`` serves Jamba (Mamba, attention, MoE) and xLSTM
    at smoke size; the default paged engine refuses them, as the
    reference's launcher does. Under ``--full`` Jamba takes the first 5
    blocks of its published order, widths kept."""
    rep = serve.main(["--arch", arch, *SMALL, "--engine", "dense"])
    assert all(len(t) == 5 for t in rep["tokens_by_request"])
    assert capsys.readouterr().out.startswith(
        f"[serve] {arch} (smoke, dense, cpu): 3 requests")
    with pytest.raises(ValueError, match="attention-only"):
        serve.main(["--arch", arch, *SMALL])
    published = get_config(arch)
    cut = serve.model_config(arch, full=True)
    if arch == "xlstm_125m":
        assert cut == published
        return
    assert serve.FULL_DEPTH_CUT[arch] == 5
    assert cut.n_layers == len(cut.pattern) == 5
    assert cut.pattern == published.pattern[:5]
    assert [b.kind for b in cut.pattern] == ["mamba"] * 4 + ["attn"]
    assert [b.ffn for b in cut.pattern] == ["dense", "moe"] * 2 + ["dense"]
    assert cut == dataclasses.replace(published, n_layers=5,
                                      pattern=published.pattern[:5])


def test_launcher_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="pool-backed"):
        serve.main(["--engine", "dense", "--disagg", "--device", "cpu"])
    # the frontend-stub families, refused with the reference's reason
    for arch in ("seamless_m4t_large_v2", "internvl2_26b"):
        with pytest.raises(SystemExit, match="frontend-stub archs serve "
                                             "via examples/ drivers"):
            serve.main(["--arch", arch, "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown arch"):
        serve.main(["--arch", "gpt2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "olmo_1b"])


@pytest.mark.parametrize("mode", [[], ["--disagg"]],
                         ids=["spatial", "spatial-disagg"])
def test_launcher_serves_spatial(capsys, mode):
    """``--engine spatial --shards 2`` serves on the CPU (STAR switched
    off, as the reference launcher does), alone and as the prefill side
    of a disaggregated pair."""
    rep = serve.main(["--arch", "olmo_1b", *SMALL, "--engine", "spatial",
                      "--shards", "2", *mode])
    toks = rep["tokens_by_request"]
    assert rep["requests"] == 3 and rep["tokens"] == sum(map(len, toks))
    assert all(len(t) == 5 or ("--disagg" in mode and t[-1] == 1)
               for t in toks)
    line = capsys.readouterr().out.splitlines()[0]
    assert "spatial, 2 shards" in line and "star=off" in line
    if "--disagg" in mode:
        assert "transfers=" in line


def test_launcher_chunks_whole_star_tiles():
    """The paged engine's prefill chunk is a whole number of STAR q-tiles
    (the backend refuses others): 4 pages at the smoke tiles of 16, 8 at
    the published tiles of 128."""
    from repro_torch.configs import get_config, get_smoke_config
    assert serve.tile_chunk_pages(get_smoke_config("olmo_1b"), 16) == 4
    assert serve.tile_chunk_pages(get_config("chatglm3_6b"), 16) == 8
    assert serve.tile_chunk_pages(get_config("star_paper"), 32) == 4
    assert serve.tile_chunk_pages(dataclasses.replace(
        get_config("starcoder2_15b"), star=None), 16) == 4
