"""The port's bench flags (forest_slam_tpu_torch/bench.py) against the
repository's bench.py, and the paths they reach, on the CPU.

- The port's parser has every option of bench.py but ``--platform``, with
  its default, choices and action (read from bench.py with ``ast``).
- The tier, weights, refine radius, front end, ``--quick`` sizes and
  ``--frames`` resolve as bench.py's own statements resolve them (run as
  they stand there); hypotheses and the SuperGlue and cost-path names too.
- The chunked runner equals the device runner bit for bit, with the PnP
  draws from a generator and handed in, with exposure compensation and its
  artifacts; a ``frame_indices`` run equals a run on the stack it indexes.
- ``--refine-cost-path pallas`` raises on the CPU, ``xla`` is the plain
  version; ``--sg-gnn fused`` and ``--sg-attention fused`` are the kernel
  route (the plain version on the CPU), ``flash`` (the library's attention)
  holds to the dense path and the plain version within the tolerances of
  ``flash_tolerances`` and averages a fully masked sequence as the dense
  path does.
- ``main(["--quick", "--frames", "4", "--no-gates", "--device", "cpu"])``
  ends with a line holding every field of bench.py's emit, ``mfu`` null;
  ORB with ``--profile``, ``--runner chunked`` and ``--drift-from`` writes
  its trace and its drift; ``drift_record`` warns on a doubled gate ATE.
"""

import argparse
import ast
import json
import os

import pytest
import torch

from forest_slam_tpu_torch import bench
from forest_slam_tpu_torch.frontend.refine import RefineConfig, refine_matches_quality
from forest_slam_tpu_torch.frontend.superglue import SuperGlue, SuperGlueConfig, attention, dense_attention
from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, WEIGHTS_DIR
from forest_slam_tpu_torch.pipelines.stereo import run_stereo_vo_batched, run_stereo_vo_device
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_main():
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _bench_options():
    """bench.py's add_argument calls: option -> {default, choices, action}."""
    out = {}
    for n in ast.walk(_bench_main()):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in n.keywords}
            out[n.args[0].value] = {k: ast.literal_eval(kw[k]) for k in ("default", "choices", "action") if k in kw}
    return out


def _emitted_names():
    call = next(n for n in ast.walk(_bench_main()) if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "emit")
    return [k.arg for k in call.keywords if k.arg]


def test_parser_has_every_bench_py_option():
    theirs = _bench_options()
    ours = {a.option_strings[0]: a for a in bench.build_parser()._actions if a.option_strings}
    assert set(theirs) - {"--platform"} <= set(ours)
    for opt, spec in theirs.items():
        if opt == "--platform":
            continue
        a = ours[opt]
        assert a.default == spec.get("default", False if spec.get("action") == "store_true" else None), opt
        if "choices" in spec:
            assert list(a.choices) == spec["choices"], opt
        if spec.get("action") == "store_true":
            assert isinstance(a, argparse._StoreTrueAction), opt
    assert set(ours) - set(theirs) == {"--drift-from", "--no-gates", "--device", "-h"}
    assert list(bench.EMIT_KEYS) == ["metric", "value", "unit", "vs_baseline"] + _emitted_names()


def _bench_py_resolution(argv, weights_dir):
    """Run bench.py's own resolving statements (its tier preset, front end,
    --quick and --frames blocks) on its parsed args."""
    wanted = ("args.weights is None", "args.refine_radius < 0 and args.tier == 'accuracy'", "args.frontend == 'auto'",
              "args.quick", "args.frames")
    stmts = [n for n in _bench_main().body if isinstance(n, ast.If) and ast.unparse(n.test) in wanted]
    assert len(stmts) == len(wanted)
    args = bench.build_parser().parse_args(argv)
    scope = {"args": args, "os": os, "REPO": os.path.dirname(weights_dir),
             "WEIGHTS_PATH": os.path.join(weights_dir, os.path.basename(FLAGSHIP_PATH))}
    exec(compile(ast.Module(body=stmts, type_ignores=[]), "bench.py", "exec"), scope)
    return args, scope


@pytest.mark.parametrize("argv", [[], ["--tier", "accuracy"], ["--tier", "accuracy", "--refine-radius", "5"],
                                  ["--quick"], ["--quick", "--frames", "4"], ["--frames", "97"],
                                  ["--weights", "absent.msgpack"], ["--frontend", "orb", "--tier", "accuracy"],
                                  ["--tier", "accuracy", "--weights", FLAGSHIP_PATH]])
def test_flags_resolve_as_bench_py(argv):
    args, scope = _bench_py_resolution(argv, WEIGHTS_DIR)
    st = bench.resolve(bench.build_parser().parse_args(argv))
    assert st.weights == args.weights and st.frontend == args.frontend
    assert (st.height, st.width, st.n_frames, st.n_unique) == (scope["H"], scope["W"], scope["n_frames"],
                                                               scope["n_unique"])
    assert (st.config["n_kpts"], st.config["n_disp"]) == (scope["n_kpts"], scope["n_disp"])
    assert st.config["orb_levels"] == (4 if args.quick else 8)
    assert st.config["n_hypotheses"] == (args.hypotheses or (512 if args.quick else 1024))
    cfg = bench.main_config(st.frontend, **st.config)
    # bench.py's auto radius, set once the front end is known (bench.py:342-347)
    radius = args.refine_radius if args.refine_radius >= 0 else (12 if args.frontend == "sp" else 0)
    assert cfg.match_refine_radius == radius
    assert st.tier == args.tier
    assert st.sg == {"softmax_dtype": "bfloat16", "attention_impl": "auto", "gnn_impl": "auto"}


def test_accuracy_tier_without_its_checkpoint(tmp_path, monkeypatch):
    """Where weights/learned_frontend.msgpack is absent the accuracy tier
    runs the flagship at radius 24, as bench.py does, and the record's tier
    says which checkpoint ran."""
    monkeypatch.setattr(bench, "ACCURACY_CHECKPOINT", "absent.msgpack")
    argv = ["--tier", "accuracy", "--hypotheses", "100", "--sg-attention", "flash", "--sg-gnn", "xla",
            "--sg-softmax", "float32", "--refine-cost-path", "xla"]
    st = bench.resolve(bench.build_parser().parse_args(argv))
    assert st.weights == FLAGSHIP_PATH and st.tier.startswith("accuracy (absent.msgpack absent")
    assert os.path.basename(FLAGSHIP_PATH) in st.tier
    cfg = bench.main_config(st.frontend, **st.config)
    assert (cfg.match_refine_radius, cfg.n_hypotheses, cfg.match_refine_cost_path) == (24, 100, "xla")
    assert st.sg == {"softmax_dtype": "float32", "attention_impl": "flash", "gnn_impl": "xla"}


def _clip(n_unique=4, h=96, w=128):
    il, ir, Ts, rig = bench.render_clip("corridor", n_unique, bench.SPEED, "cpu", h, w)
    return il, ir, rig


@pytest.mark.parametrize("photo_norm, drawn", [(False, "generator"), (True, "given")])
def test_chunked_runner_equals_device_runner(photo_norm, drawn):
    """ORB at 224x160 (256 features, 4 levels, refine radius 4), 9 virtual
    frames of 4 unique, chunks of 4 frames and 3 pairs."""
    il, ir, rig = _clip(h=160, w=224)
    idx = torch.as_tensor(bench.frame_index(9, 4), dtype=torch.long)
    cfg = bench.main_config("orb", n_kpts=256, orb_levels=4, n_hypotheses=64, refine_radius=4)._replace(
        photo_norm=photo_norm)
    from forest_slam_tpu_torch.frontend.base import orb_frontend

    fns = orb_frontend(cfg.orb, cfg.max_match_distance)

    def draws():
        if drawn == "given":
            g = torch.Generator()
            g.manual_seed(3)
            return dict(generator=None, gumbel=-torch.log(-torch.log(torch.rand(8, 64, 256, generator=g) * 0.999 + 5e-4)),
                        uniform=torch.rand(8, 256, generator=g) * 0.999 + 5e-4)
        g = torch.Generator()
        g.manual_seed(0)
        return dict(generator=g)

    d = draws()
    dev_out, dev_art = run_stereo_vo_device(il[idx], ir[idx], rig, cfg, d.pop("generator"), fns, 4, 3,
                                            return_artifacts=True, **d)
    d = draws()
    ch_out, ch_art = run_stereo_vo_batched(il, ir, rig, cfg, d.pop("generator"), fns, frame_chunk=4, pair_chunk=3,
                                           frame_indices=idx, return_artifacts=True, **d)
    d = draws()
    stack_out = run_stereo_vo_batched(il[idx], ir[idx], rig, cfg, d.pop("generator"), fns, frame_chunk=4,
                                      pair_chunk=3, **d)
    for a, b, c in zip(dev_out, ch_out, stack_out):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(dev_art[:5], ch_art[:5]):
        assert torch.equal(a, b)
    assert dev_out.pose.shape == (8, 4, 4) and int(dev_out.ok.sum()) >= 6


def test_workload_runners_agree():
    """A small learned workload (160x224, K=256, two layer pairs): its two
    runs, device and chunked, give the same poses and flags."""
    from forest_slam_tpu_torch.frontend.weights import load_learned_frontend

    fe = load_learned_frontend(FLAGSHIP_PATH, (160, 224), 256, device="cpu", superglue_overrides={"gnn_layers": 2})
    wl = bench.prepare_workload("sp", "cpu", n_frames=7, n_unique=3, height=160, width=224, fe=fe, frame_chunk=4,
                                pair_chunk=3, runner="chunked")
    assert wl.run is wl.runs["chunked"] and wl.frontend == "superpoint_superglue"
    a, b = wl.runs["device"](), wl.run()
    assert torch.equal(a.pose, b.pose) and torch.equal(a.ok, b.ok)
    with pytest.raises(ValueError, match="runner"):
        bench.prepare_workload("orb", "cpu", n_frames=3, n_unique=2, height=96, width=128, runner="scan")


def test_refine_cost_paths_on_the_cpu():
    g = torch.Generator()
    g.manual_seed(0)
    img0, img1 = (torch.randint(0, 256, (2, 60, 80), generator=g).float() for _ in range(2))
    xy0 = torch.rand(2, 16, 2, generator=g) * torch.tensor([79.0, 59.0])
    xy1 = xy0 + torch.randn(2, 16, 2, generator=g)
    valid = torch.rand(2, 16, generator=g) < 0.8
    outs = [refine_matches_quality(img0, img1, xy0, xy1, valid, RefineConfig(radius=4, cost_path=p))
            for p in ("auto", "plain", "xla")]
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="pallas"):
        refine_matches_quality(img0, img1, xy0, xy1, valid, RefineConfig(radius=4, cost_path="pallas"))
    with pytest.raises(ValueError, match="cost_path"):
        refine_matches_quality(img0, img1, xy0, xy1, valid, RefineConfig(radius=4, cost_path="gather"))


def test_refine_cost_path_pallas_raises_through_the_pipeline():
    il, ir, rig = _clip(3)
    cfg = bench.main_config("orb", n_kpts=128, orb_levels=4, n_hypotheses=32, refine_radius=4,
                            refine_cost_path="pallas")
    from forest_slam_tpu_torch.frontend.base import orb_frontend

    g = torch.Generator()
    g.manual_seed(0)
    with pytest.raises(ValueError, match="CUDA"):
        run_stereo_vo_device(il, ir, rig, cfg, g, orb_frontend(cfg.orb, cfg.max_match_distance), 3, 2)


def _heads(B=3, h=4, K=48, S=40):
    g = torch.Generator()
    g.manual_seed(1)
    q, k, v = ((torch.randn(B, h, n, 64, generator=g) * s).to(torch.bfloat16) for n, s in ((K, 2), (S, 2), (S, 1)))
    mask = torch.rand(B, S, generator=g) < 0.7
    mask[-1] = False  # a sequence whose sources are all masked
    return q, k, v, mask


def flash_tolerances(flash, dense, plain):
    """``flash`` against the dense path (bf16 logits: a logit of 30 rounds
    by 0.125): max within 2^-5, mean within 2^-9 of the largest dense
    output; against the plain version (float32 logits, the attention
    kernel's numerics) within the kernel's tolerance, 2^-7 and 1e-3."""
    top = dense.abs().max()
    return bool(torch.isfinite(flash).all() and (flash - dense).abs().max() <= 2.0 ** -5 * top
                and (flash - dense).abs().mean() <= 2.0 ** -9 * top and (flash - plain).abs().max() <= 2.0 ** -7 * top
                and (flash - plain).abs().mean() <= 1e-3 * top)


def test_attention_names():
    q, k, v, mask = _heads()
    assert torch.equal(attention(q, k, v, mask, "fused"), attention(q, k, v, mask, "auto"))
    flash = attention(q, k, v, mask, "flash").float()
    assert flash_tolerances(flash, dense_attention(q, k, v, mask, "bfloat16").float(),
                            attention(q, k, v, mask, "plain").float())
    # the fully masked sequence averages v, as the dense path's NEG mask does
    assert (flash[-1] - v[-1].float().mean(dim=1, keepdim=True)).abs().max() <= 2.0 ** -7
    with pytest.raises(ValueError):
        attention(q, k, v, mask, "stock")


def test_superglue_impl_names():
    """The JAX names of the layer and attention routes: ``fused`` is the
    kernel route (its plain version here), so the matcher's output is the
    same; ``flash`` in the unfused layer matches as the dense one does."""
    torch.manual_seed(0)
    B, K = 2, 64
    args = []
    for _ in range(2):
        xy = torch.rand(B, K, 2) * torch.tensor([128.0, 96.0])
        args += [xy, torch.rand(B, K), torch.nn.functional.normalize(torch.randn(B, K, 256), dim=-1),
                 torch.rand(B, K) < 0.9]
    ref = SuperGlue(SuperGlueConfig(gnn_layers=2))
    outs = {}
    for name, over in (("auto", {}), ("fused", dict(gnn_impl="fused")), ("xla", dict(gnn_impl="xla")),
                       ("xla-fused", dict(gnn_impl="xla", attention_impl="fused")),
                       ("flash", dict(gnn_impl="xla", attention_impl="flash"))):
        sg = SuperGlue(SuperGlueConfig(gnn_layers=2, **over))
        sg.load_state_dict(ref.state_dict())
        with torch.no_grad():
            outs[name] = sg(*args, (96, 128))
    for a, b in zip(outs["auto"], outs["fused"]):
        assert torch.equal(a, b)
    for a, b in zip(outs["xla"], outs["xla-fused"]):
        assert torch.equal(a, b)
    agree = (outs["flash"].matches0 == outs["xla"].matches0).float().mean()
    assert agree >= 0.95
    with pytest.raises(ValueError):
        SuperGlue(SuperGlueConfig(gnn_layers=1, gnn_impl="pallas"))(*args, (96, 128))


def _last_record(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_main_quick_on_the_cpu(capsys):
    assert bench.main(["--quick", "--frames", "4", "--no-gates", "--device", "cpu"]) == 0
    rec = _last_record(capsys)
    assert set(bench.EMIT_KEYS) <= set(rec) and set(_emitted_names()) <= set(rec)
    assert rec["mfu"] is None and rec["hbm_frac"] is None and rec["roofline_frac"] is None
    assert rec["bytes_accounting"] == "formula" and rec["device"] == "cpu" and rec["device_pairs_per_sec"] is None
    assert rec["n_frames"] == 3 and rec["tier"] == "speed" and rec["drift"] is None
    assert rec["lowres_ok_frames"] is None and rec["gate_failures"] is None


def test_main_orb_profile_chunked_drift(tmp_path, capsys):
    before = tmp_path / "before.txt"
    before.write_text("# a stderr line\n" + json.dumps({"value": 1.0, "ate_rmse": 0.001, "wb_k10_ate": 0.01}) + "\n")
    trace_dir = tmp_path / "trace"
    argv = ["--quick", "--frames", "5", "--frontend", "orb", "--device", "cpu", "--runner", "chunked", "--profile",
            str(trace_dir), "--drift-from", str(before), "--no-device-time", "--hypotheses", "64"]
    assert bench.main(argv) == 0
    captured = capsys.readouterr()
    rec = json.loads(captured.out.strip().splitlines()[-1])
    assert rec["frontend"] == "orb" and rec["n_frames"] == 4 and rec["device_pairs_per_sec"] is None
    assert rec["drift"]["vs"] == "before.txt" and rec["drift"]["value"][0] == 1.0
    assert set(rec["drift"]) == {"vs", "value", "ate_rmse"}
    assert (trace_dir / "trace.json").stat().st_size > 0
    assert "the ten operations with the most CPU time" in captured.err


def test_drift_record_warns_on_a_doubled_gate(tmp_path, capsys):
    path = tmp_path / "prev.json"
    path.write_text(json.dumps({"value": 500.0, "ate_rmse": 0.04, "wb_k10_ate": 0.006, "wb_k10_ok": 15,
                                "fwb_k20_ate": 0.03}))
    drift = bench.drift_record(str(path), {"value": 510.0, "ate_rmse": 0.05, "wb_k10_ate": 0.013, "wb_k10_ok": 15,
                                           "wb_k20_ate": 0.02, "ok_frames": 962})
    assert drift == {"vs": "prev.json", "value": [500.0, 510.0], "ate_rmse": [0.04, 0.05],
                     "wb_k10_ate": [0.006, 0.013], "wb_k10_ok": [15, 15]}
    assert "DRIFT WARNING: wb_k10_ate 0.006 -> 0.013" in capsys.readouterr().err
    (tmp_path / "junk.txt").write_text("no json here\n")
    with pytest.raises(ValueError):
        bench.read_record(str(tmp_path / "junk.txt"))


def test_main_needs_a_card_or_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--quick"]) == 1
    assert "--device cpu" in capsys.readouterr().err
