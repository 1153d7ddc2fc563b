"""The port stands alone: no module of gtcrn_micro_tpu_torch, and not
chip_smoke.py, imports jax, the JAX package, or the root ``bench.py`` and
``scripts/`` (the JAX system's measuring programs, which the port's
``bench.py`` and ``scripts/`` replace).

The check reads the sources (an AST scan) rather than ``sys.modules``: the
test process imports both packages, and a host may pre-import jax.
"""

import ast
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "gtcrn_micro_tpu", "optax", "orbax", "bench", "scripts")


def _sources():
    files = sorted((ROOT / "gtcrn_micro_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    port = ROOT / "gtcrn_micro_tpu_torch"
    for module in ("parallel/mesh.py", "parallel/multiproc.py", "io/export_native.py",
                   "runtime/native.py", "io/torch_ckpt.py", "quant/adaround.py", "quant/gptq.py",
                   "quant/mixed.py", "utils/profiling.py", "utils/complexity.py", "io/onnx.py",
                   "io/onnx_export.py", "io/export_program.py", "eval/dnsmos.py",
                   "utils/config.py", "utils/roofline.py", "bench.py", "scripts/sweep_cohort.py",
                   "scripts/throughput_mode.py", "scripts/serve_soak.py", "scripts/bench_int8.py",
                   "scripts/train_speed.py", "scripts/roofline.py", "scripts/profile_serving.py",
                   "scripts/profile_train.py", "scripts/smoke_all.py", "scripts/ref_scale_run.py",
                   "scripts/ref_scale_snapshot.py", "scripts/sweep_chunk.py",
                   "scripts/int8_microbench.py", "scripts/ab_psum.py",
                   "scripts/ring_bank_microbench.py", "scripts/ablate_shuffle.py",
                   "scripts/leak_probe.py", "models/gtcrn_micro.py", "serve.py", "nn/blocks.py",
                   "utils/make_smoke_data.py"):
        assert port / module in files, module
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_cuda_and_refuse_without_a_gpu(monkeypatch):
    from gtcrn_micro_tpu_torch import resolve_device
    from gtcrn_micro_tpu_torch.eval.infer import enhance_wavs
    from gtcrn_micro_tpu_torch.eval.infer import main as infer_main
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
    from gtcrn_micro_tpu_torch.ops.fused_step import FusedGTCRNMicro
    from gtcrn_micro_tpu_torch.serve import CohortServer
    from gtcrn_micro_tpu_torch.train.train import run as train_run
    from gtcrn_micro_tpu_torch.train.trainer import make_eval_step, make_optimizer, make_train_step

    params = init_params(device="cpu")
    layered = GTCRNMicro.from_params(params, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedGTCRNMicro(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CohortServer(None, params, batch=8, n_cohorts=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GTCRNMicro.from_params(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CohortServer(layered, None, batch=8, n_cohorts=1, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enhance_wavs(layered, [])
    from gtcrn_micro_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CohortServer(None, params, batch=8, n_cohorts=1, mesh=["cuda:0", "cuda:0"])
    from gtcrn_micro_tpu_torch.eval import dnsmos
    from gtcrn_micro_tpu_torch.eval.dnsmos import DEFAULT_MODEL_DIR, DnsmosScorer
    from gtcrn_micro_tpu_torch.io import export_program
    from gtcrn_micro_tpu_torch.io.onnx import OnnxModel
    from gtcrn_micro_tpu_torch.ops.int8_step import Int8Serving
    from gtcrn_micro_tpu_torch.quant import adaround, mixed, parity, qat
    from gtcrn_micro_tpu_torch.utils import profiling
    from gtcrn_micro_tpu_torch import bench
    from gtcrn_micro_tpu_torch.scripts import (
        bench_int8,
        profile_serving,
        profile_train,
        roofline,
        serve_soak,
        sweep_cohort,
        throughput_mode,
        train_speed,
    )

    from gtcrn_micro_tpu_torch import serve
    from gtcrn_micro_tpu_torch.models import gtcrn_micro
    from gtcrn_micro_tpu_torch.scripts import (
        ab_psum,
        ablate_shuffle,
        int8_microbench,
        leak_probe,
        ref_scale_run,
        ring_bank_microbench,
        smoke_all,
        sweep_chunk,
    )
    from gtcrn_micro_tpu_torch.utils import complexity

    measuring = (bench, sweep_cohort, throughput_mode, serve_soak, bench_int8, train_speed,
                 roofline, profile_serving, profile_train, sweep_chunk, int8_microbench, ab_psum,
                 ring_bank_microbench, ablate_shuffle, leak_probe, ref_scale_run, smoke_all,
                 complexity, gtcrn_micro)

    opt = make_optimizer(layered, device="cpu")
    files = ["--checkpoint", "x.npz", "--wav_dir", "d", "--wav", "x.wav", "--calib_dir", "d"]
    for call in (lambda: make_optimizer(layered), lambda: make_train_step(layered, opt),
                 lambda: make_eval_step(layered), lambda: train_run({}),
                 lambda: infer_main(["-C", "cfg.yaml"]), lambda: Int8Serving(params, {}),
                 lambda: parity.main(files[:2] + files[4:]), lambda: qat.main(files[:4]),
                 lambda: adaround.main(files[:4]), lambda: mixed.main(files[:4]),
                 lambda: adaround.load_act_qp("act_qp.npz"), lambda: mixed.qp_table({}),
                 lambda: profiling.time_fn(lambda: None), profiling.measure_rtt,
                 lambda: OnnxModel(os.path.join(DEFAULT_MODEL_DIR, "model_v8.onnx")),
                 lambda: DnsmosScorer(), lambda: dnsmos.main(["--inf_scp", "x", "--output_dir", "o"]),
                 lambda: export_program.main(["--checkpoint", "x.npz"]),
                 lambda: serve.main(["--checkpoint", "x.npz"]),
                 *(lambda m=m: m.main([]) for m in measuring)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_cpu_wrapper_never_counts_a_launch():
    """On CPU tensors the wrappers take the plain version and launch nothing."""
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro

    m = GridFusedGTCRNMicro(init_params(device="cpu"), device="cpu")
    st = m.init_state(8)
    m.step(st, torch.zeros((8, 257, 1, 2)))
    assert m.launches == 0 and st["step"] == 1
