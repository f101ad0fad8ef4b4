"""The port's distillation (forest_slam_tpu_torch.train.distill) against
train/distill.py at tests/test_distill.py's tiny size: a stride-1 teacher
of channels (8, 8, 16, 16), D=32, written by the JAX package's
``save_params`` in the trainer's layout; a stride-2 student, both packages
starting from the port's initial parameters (Flax's initialisers, drawn
from a torch seed; a JAX ``init`` costs a compile here and draws other
numbers); 48x64 crops, batch 2; the same
numpy-seeded images on both sides and the JAX package's random draws handed
to the port's ``*Draws`` tuples (each drawn here with ``jax.random`` from
the reference's own key splits).

Tolerances:
- the sampler against ``jax.scipy.ndimage.map_coordinates(order=1,
  mode="nearest")``: 1e-5 relative (the same weights and sum order; XLA
  may contract a product into a fused multiply-add);
- zoom batches within 1e-3 gray levels, zoomed cell grids within 1e-5;
- blur: the same regions, blurred values within 1e-3 gray levels (the
  reference convolves, the port sums shifted slices);
- a batch: crops and their jitter within 1e-4, the texture scenes within 0.02 gray
  levels (``jax.image.resize``'s upsampling, as tests/test_torch_train_data.py
  holds it), at most 0.2% of the corner scenes' pixels off (a rectangle
  edge across a pixel centre), the rest within 0.02;
- the loss: both networks run bf16 convolutions whose sums round in
  another order, so each metric within 5e-4 relative (measured at most
  6.2e-5, cos_kp; the subpix term 2.6e-5); the student's gradient to
  cosine 0.9999 and relative L2 0.02 (measured 0.999992 and 0.0039), each
  conv's kernel to cosine 0.9999 (measured 0.999997 or above);
- one AdamW step: optax's first update is +-lr times the gradient's sign,
  so parameters agree to 1e-6 wherever the reference's gradient exceeds 1%
  of its RMS (a third of them: dead ReLU channels give a sixth exactly zero
  gradients, where bf16 noise on either side picks a sign), and by at most
  2 lr + 1e-6 anywhere; the first moments to the gradient's cosine.
"""

import os

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from forest_slam_tpu.frontend.weights import load_meta
from forest_slam_tpu.frontend.weights import save_params as jsave_params
from forest_slam_tpu.train import distill as J
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig, SuperPointNet
from forest_slam_tpu_torch.frontend.weights import PLAIN_WB_PATH, read_checkpoint, superpoint_from_jax, \
    superpoint_to_jax
from forest_slam_tpu_torch.train import data as TD
from forest_slam_tpu_torch.train import distill as T
from forest_slam_tpu_torch.train.trainer import superpoint_init_
from forest_slam_tpu_torch.utils.filters import map_coordinates_linear

CH, DD = (8, 8, 16, 16), 32
H, W = 48, 64


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    """tests/test_distill.py's tiny stride-1 teacher: superpoint and a fake
    superglue subtree, with architecture meta."""
    path = str(tmp_path_factory.mktemp("distill") / "teacher.msgpack")
    net = SuperPointNet(SuperPointConfig(stem_stride=1, channels=CH, descriptor_dim=DD))
    g = torch.Generator()
    g.manual_seed(3)
    superpoint_init_(net, g)
    params = {"params": superpoint_to_jax(net)}
    fake_sg = {"params": {"proj": jnp.ones((4, 4), jnp.float32)}}
    jsave_params({"superpoint": params, "superglue": fake_sg}, path,
                 meta={"stem_stride": 1, "gnn_layers": 2, "sinkhorn_iterations": 5})
    return path


def tiny_cfg(teacher_ckpt, **kw):
    base = dict(teacher_path=teacher_ckpt, channels=CH, descriptor_dim=DD, height=H, width=W, batch_size=2,
                learning_rate=2e-3, pool_frames=2, pool_height=96, pool_width=128)
    base.update(kw)
    return (J.DistillConfig(**base), T.DistillConfig(**base))


def _t(a):
    return torch.as_tensor(np.array(a))


def _u(key, shape, lo=0.0, hi=1.0):
    return _t(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _images(seed, n=2):
    return np.random.RandomState(seed).uniform(0, 255, (n, H, W)).astype(np.float32)


def _port_student(jparams, cfg):
    return superpoint_from_jax(jax.tree.map(np.asarray, jparams["params"]),
                               SuperPointConfig(stem_stride=cfg.stem_stride, channels=CH, descriptor_dim=DD))


def jax_blur_draws(key, cfg, shape):
    """The port's BlurBatchDraws of J._blur_batch(key, images, cfg)."""
    kp, ka, km = jax.random.split(key, 3)
    B = shape[0]
    return T.BlurBatchDraws(
        percentage=_u(kp, (B,), cfg.blur_pct_min / 100.0, cfg.blur_pct_max / 100.0),
        angle=_u(ka, (B,), 0.0, 180.0),
        seeds=torch.stack([_u(k, shape[1:]) for k in jax.random.split(km, B)]))


def jax_zoom_ratios(key, cfg):
    return _u(key, (cfg.batch_size,), cfg.scale_min, cfg.scale_max)


def jax_batch_draws(key, cfg, pool_shape):
    """The port's DistillBatchDraws of J._distill_batch(key, cfg, pool)."""
    n_scene, n_tex, n_cor = T.batch_split(cfg)
    N, PH, PW = pool_shape
    k_scene, k_tex, k_cor, k_jit = jax.random.split(key, 4)
    ki, ky, kx = jax.random.split(k_scene, 3)
    ri = lambda k, hi: torch.as_tensor(np.array(jax.random.randint(k, (n_scene,), 0, hi)), dtype=torch.int64)
    tex = []
    for k in jax.random.split(k_tex, n_tex):
        ks = jax.random.split(k, 3)
        tex.append(TD.TextureDraws(_u(ks[0], (H // 8, W // 8)), _u(ks[1], (H // 2, W // 2)), _u(ks[2], (H, W))))
    cor, S, m = [], 12, min(H, W)
    for k in jax.random.split(k_cor, n_cor):
        ks = jax.random.split(k, 6)
        cor.append(TD.CornerDraws(
            bg=_u(ks[0], (H, W)),
            centers=_u(ks[1], (S, 2), jnp.array([W * 0.1, H * 0.1]), jnp.array([W * 0.9, H * 0.9])),
            sizes=_u(ks[2], (S, 2), m * 0.08, m * 0.35), angles=_u(ks[3], (S,), 0.0, jnp.pi),
            intensities=_u(ks[4], (S,), 0.0, 255.0), order=_u(ks[5], (4 * S,))))
    kn, kg, kb = jax.random.split(k_jit, 3)
    B = cfg.batch_size
    return T.DistillBatchDraws(
        crop_index=ri(ki, N), crop_y=ri(ky, PH - H + 1), crop_x=ri(kx, PW - W + 1),
        texture=TD.TextureDraws(*(torch.stack(x) for x in zip(*tex))),
        corner=TD.CornerDraws(*(torch.stack(x) for x in zip(*cor))),
        log_gain=_u(kg, (B,), -cfg.max_gain, cfg.max_gain), bias=_u(kb, (B,), -cfg.max_bias, cfg.max_bias),
        noise=_t(jax.random.normal(kn, (B, H, W))))


@pytest.fixture(scope="module")
def step(teacher_ckpt):
    """Both packages' step from the same student, teacher and inputs, all
    five terms on: JAX's loss, metrics and gradient and its optax update
    (train/distill.py:_distill_step_raw's arithmetic) in one compile; the
    port's loss and gradient, and its distill_step from a fresh copy."""
    import optax

    jcfg, tcfg = tiny_cfg(teacher_ckpt, w_blur=0.7, w_subpix=0.5, blur_kernel=5)
    jteacher, jt_params, _, _ = J.load_teacher(jcfg)
    init = T.create_student_state(tcfg, seed=0, device="cpu")
    jstudent = {"params": jax.tree.map(jnp.asarray, superpoint_to_jax(init.student))}
    images = _images(1)
    zk, bk = jax.random.split(jax.random.PRNGKey(7))
    jzoom = J._zoom_batch(zk, jnp.asarray(images), jcfg)
    jblurred = J._blur_batch(bk, jnp.asarray(images), jcfg)

    @jax.jit
    def jax_step(p):
        t_out = jteacher.apply(jt_params, jnp.asarray(images) / 255.0)
        g, m = jax.grad(J.distill_loss, has_aux=True)(p, t_out, jnp.asarray(images), jcfg, jzoom, jblurred)
        tx = J._make_optimizer(jcfg)
        updates, opt_state = tx.update(g, tx.init(p), p)
        return g, m, optax.apply_updates(p, updates), opt_state

    jg, jm, jnew, jopt = jax_step(jstudent)

    teacher, tree, meta = T.load_teacher(tcfg, "cpu")
    student = _port_student(jstudent, tcfg)
    ti = torch.as_tensor(images)
    tzoom = T.zoom_batch(ti, jax_zoom_ratios(zk, tcfg))
    tblurred = T.blur_batch(ti, jax_blur_draws(bk, tcfg, images.shape), tcfg.blur_kernel)
    with torch.no_grad():
        t_out = teacher(ti / 255.0)
    total, tm = T.distill_loss(student, t_out, ti, tcfg, tzoom, tblurred)
    total.backward()
    new_state, new_metrics = T.distill_step(init, teacher, ti, tcfg, tzoom, tblurred)
    return dict(jcfg=jcfg, tcfg=tcfg, jg=jg, jm=jm, jnew=jnew, jopt=jopt, student=student, tm=tm, jzoom=jzoom,
                tzoom=tzoom,
                new_state=new_state, new_metrics=new_metrics, tree=tree, meta=meta, teacher=teacher)


def test_sampler_matches_map_coordinates():
    from jax.scipy.ndimage import map_coordinates

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 13, 17)).astype(np.float32)
    # inside, on the border and past every edge
    y = rng.uniform(-3, 16, (2, 9, 11)).astype(np.float32)
    x = rng.uniform(-3, 20, (2, 9, 11)).astype(np.float32)
    y[:, 0, :3], x[:, 0, :3] = [[0.0, 12.0, 12.5]], [[0.0, 16.0, 16.5]]
    ref = np.stack([np.asarray(map_coordinates(img[b], [y[b], x[b]], order=1, mode="nearest")) for b in range(2)])
    got = map_coordinates_linear(_t(img), _t(y), _t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    grid = rng.standard_normal((2, 13, 17, 3)).astype(np.float32)
    ref_c = np.stack([np.stack([np.asarray(map_coordinates(grid[b, ..., c], [y[b], x[b]], order=1, mode="nearest"))
                                for c in range(3)], -1) for b in range(2)])
    np.testing.assert_allclose(map_coordinates_linear(_t(grid), _t(y), _t(x)).numpy(), ref_c, rtol=1e-5, atol=1e-6)


def test_zoom_batch_and_cells_at_zoom(step):
    images_z, ratios = step["tzoom"]
    np.testing.assert_array_equal(ratios.numpy(), np.asarray(step["jzoom"][1]))
    np.testing.assert_allclose(images_z.numpy(), np.asarray(step["jzoom"][0]), atol=1e-3)
    grid = np.random.default_rng(1).standard_normal((2, H // 8, W // 8, DD)).astype(np.float32)
    ref = np.asarray(J._sample_cells_at_zoom(jnp.asarray(grid), step["jzoom"][1]))
    np.testing.assert_allclose(T.sample_cells_at_zoom(_t(grid), ratios).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("kernel", [5, 15])
def test_blur_batch(teacher_ckpt, kernel):
    jcfg, tcfg = tiny_cfg(teacher_ckpt, w_blur=1.0, blur_kernel=kernel)
    images = _images(4)
    key = jax.random.PRNGKey(kernel)
    ref = np.asarray(J._blur_batch(key, jnp.asarray(images), jcfg))
    got = T.blur_batch(torch.as_tensor(images), jax_blur_draws(key, tcfg, images.shape), kernel).numpy()
    assert (np.abs(ref - images) > 0).any()
    np.testing.assert_array_equal(got == images, ref == images)  # the same regions
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_distill_batch(teacher_ckpt):
    jcfg, tcfg = tiny_cfg(teacher_ckpt, batch_size=4)
    assert T.batch_split(tcfg) == (2, 1, 1)
    pool = np.random.RandomState(0).uniform(0, 255, (3, 96, 128)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.jit(J._distill_batch, static_argnums=1)(key, jcfg, jnp.asarray(pool)))
    draws = jax_batch_draws(key, tcfg, pool.shape)
    got = T.distill_batch(draws, tcfg, torch.as_tensor(pool)).numpy()
    # the crops: the pool's pixels (up to the rounding of x - 127.5 + 127.5
    # without jitter), then the same jitter arithmetic
    no_jitter = draws._replace(log_gain=torch.zeros(4), bias=torch.zeros(4), noise=torch.zeros(4, H, W))
    crops = T.distill_batch(no_jitter, tcfg, torch.as_tensor(pool)).numpy()[:2]
    for b in range(2):
        i, y, x = (int(t[b]) for t in (draws.crop_index, draws.crop_y, draws.crop_x))
        np.testing.assert_allclose(crops[b], pool[i, y:y + H, x:x + W], atol=1e-4)
    np.testing.assert_allclose(got[:2], ref[:2], atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], atol=0.02)
    off = np.abs(got[3] - ref[3]) > 0.02
    assert off.mean() <= 0.002, off.mean()


def test_distill_loss_and_metrics(step):
    jm, tm = step["jm"], step["tm"]
    assert list(tm) == ["det", "desc", "cos_kp", "subpix", "scale", "blur", "loss"] and set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=5e-4, err_msg=k)
    assert float(jm["scale"]) > 0.1 and float(jm["blur"]) > 1.0 and float(jm["subpix"]) > 0


def _grad_tree(student):
    g = superpoint_to_jax(type(student)(student.cfg))
    for name, conv in student.convs.items():
        g[name] = {"kernel": conv.weight.grad.permute(2, 3, 1, 0).numpy(), "bias": conv.bias.grad.numpy()}
    return g


def _cos(a, b):
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def test_student_gradient(step):
    jg = jax.tree.map(np.asarray, step["jg"]["params"])
    tg = _grad_tree(step["student"])
    a = np.concatenate([np.ravel(jg[n][k]) for n in jg for k in ("kernel", "bias")]).astype(np.float64)
    b = np.concatenate([np.ravel(tg[n][k]) for n in jg for k in ("kernel", "bias")]).astype(np.float64)
    assert _cos(a, b) >= 0.9999, _cos(a, b)
    assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 0.02
    for n in jg:
        assert _cos(np.ravel(jg[n]["kernel"]), np.ravel(tg[n]["kernel"])) >= 0.9999, n


def test_one_adamw_step(step):
    """The port's distill_step (teacher, loss, AdamW) against JAX's loss,
    gradient and optax update from the same student and inputs."""
    import optax

    state, metrics = step["new_state"], step["new_metrics"]
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(step["jm"]["loss"]), rtol=5e-4)
    lr = step["tcfg"].learning_rate
    new = superpoint_to_jax(state.student)
    ref = jax.tree.map(np.asarray, step["jnew"]["params"])
    d = np.concatenate([np.ravel(np.abs(new[n][k] - ref[n][k])) for n in ref for k in ("kernel", "bias")])
    assert d.max() <= 2 * lr + 1e-6
    g = np.concatenate([np.ravel(np.asarray(step["jg"]["params"][n][k])) for n in ref for k in ("kernel", "bias")])
    signal = np.abs(g) > 0.01 * np.sqrt(np.mean(g ** 2))
    assert signal.mean() > 0.2
    assert (d[signal] <= 1e-6).all()
    adam = step["jopt"][0]
    assert isinstance(adam, optax.ScaleByAdamState)
    mu = jax.tree.map(np.asarray, adam.mu["params"])
    m = {n: state.optimizer.state[c.weight]["exp_avg"].permute(2, 3, 1, 0).numpy()
         for n, c in state.student.convs.items()}
    a = np.concatenate([np.ravel(mu[n]["kernel"]) for n in mu])
    b = np.concatenate([np.ravel(m[n]) for n in mu])
    assert _cos(a, b) >= 0.9999


def test_save_distilled_bytes_and_meta(step, tmp_path):
    jcfg, tcfg = step["jcfg"], step["tcfg"]
    payload = {"superpoint": {"params": superpoint_to_jax(step["student"])}, "superglue": step["tree"]["superglue"]}
    ours, ref = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    T.save_distilled(payload, tcfg, ours, step["meta"])
    J.save_distilled(payload, jcfg, ref, load_meta(jcfg.teacher_path))
    raw = open(ours, "rb").read()
    assert raw == open(ref, "rb").read()
    assert load_meta(ours) == {"stem_stride": 2, "gnn_layers": 2, "sinkhorn_iterations": 5}
    restored = serialization.msgpack_restore(raw)["params"]
    np.testing.assert_array_equal(restored["superglue"]["params"]["proj"], np.ones((4, 4), np.float32))
    # a teacher without meta: the loader's defaults are recorded
    T.save_distilled(payload, tcfg._replace(stem_stride=4), ours, {})
    assert load_meta(ours) == {"gnn_layers": 9, "sinkhorn_iterations": 20, "stem_stride": 4}


def test_load_teacher_keeps_the_tree(step):
    assert step["teacher"].cfg.stem_stride == 1
    assert not any(p.requires_grad for p in step["teacher"].parameters())
    assert set(step["tree"]) == {"superpoint", "superglue"} and step["meta"]["stem_stride"] == 1


def test_distill_steps_reduce_loss(teacher_ckpt):
    """test_distill.py:88-99's rule on the port: 8 steps, the last logged
    loss below the first; the pool rendered by make_scene_pool."""
    _, cfg = tiny_cfg(teacher_ckpt)
    state, history, payload = T.distill(cfg, 8, seed=1, log_every=4, device="cpu")
    assert state.step == 8 and [s for s, _ in history] == [3, 7]
    first, last = history[0][1], history[-1][1]
    assert np.isfinite(last["loss"]) and last["loss"] < first["loss"]
    assert set(payload) == {"superpoint", "superglue"} and "scale" in last


def test_scene_pool():
    _, cfg = tiny_cfg("unused", pool_frames=10, pool_height=48, pool_width=64)
    g = torch.Generator()
    g.manual_seed(0)
    pool = T.make_scene_pool(g, cfg, device="cpu")
    assert pool.shape == (10, 48, 64)
    assert torch.isfinite(pool).all() and pool.min() >= 0 and pool.max() <= 255
    assert pool.std(dim=(1, 2)).min() > 5  # every station sees texture


def test_entry_point_cpu(tmp_path):
    """python -m forest_slam_tpu_torch.train.distill at --device cpu: the
    round-5 recipe's teacher (stem 2) into a stem-4 student, two steps at a
    small size; JAX's loader reads the checkpoint and the port's front-end
    loader loads it."""
    from forest_slam_tpu.frontend.weights import load_meta as jload_meta
    from forest_slam_tpu_torch.frontend.weights import load_learned_frontend

    out = str(tmp_path / "distilled.msgpack")
    assert T.main(["--teacher", PLAIN_WB_PATH, "--out", out, "--steps", "2", "--batch", "2", "--height", "48",
                   "--width", "64", "--pool-frames", "2", "--pool-height", "96", "--pool-width", "128",
                   "--stem-stride", "4", "--w-blur", "0.7", "--w-subpix", "0.5", "--log-every", "1",
                   "--device", "cpu"]) == 0
    meta = jload_meta(out)
    assert meta["stem_stride"] == 4 and meta["gnn_layers"] == 9 and meta["sinkhorn_iterations"] == 20
    tmeta, teacher = read_checkpoint(PLAIN_WB_PATH)
    assert {k: v for k, v in meta.items() if k != "stem_stride"} == {k: v for k, v in tmeta.items()
                                                                     if k != "stem_stride"}
    restored = serialization.msgpack_restore(open(out, "rb").read())["params"]
    assert restored["superpoint"]["params"]["enc1_0"]["kernel"].shape == (3, 3, 16, 64)
    flat = lambda t: {k: flat(v) if isinstance(v, dict) else v for k, v in t.items()}
    same = jax.tree.map(lambda a, b: a.dtype == b.dtype and np.array_equal(a, b), flat(restored["superglue"]),
                        flat(teacher["superglue"]))
    assert all(jax.tree.leaves(same))
    fe = load_learned_frontend(out, (H, W), 64, device="cpu")
    assert fe.cfg.superpoint.stem_stride == 4 and os.path.getsize(out) > 0
