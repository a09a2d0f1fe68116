"""The port's utilities vs the JAX package's on the CPU: ``viz.reduce``
(SVD, t-SNE, the UMAP fallback) and the figures (PNG files, the figure
epoch pushing images to a stubbed W&B and to TensorBoard), the profiling
helpers, and the exported embedder (``torch.export``) against its live
model and against the JAX package's exported artifact on the same weights;
the fused-frontend artifact holds the log-mel kernel as one operator."""

import io
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch.models import get_titanet  # noqa: F401  (package import order)
from titanet_torch.models.titanet import TitaNet as TorchTitaNet
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.utils import export as tx
from titanet_torch.utils import viz as tv
from titanet_torch.utils.weights import load_jax_variables
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.utils import viz as jv


def _png(path) -> bool:
    return os.path.getsize(path) > 0 and open(path, "rb").read(4) == b"\x89PNG"


@pytest.mark.parametrize("method", ["svd", "tsne", "umap"])
def test_reduce_matches_jax(method):
    """The same projection as the JAX package's with the same seed;
    "umap" falls back to SVD (the package is not installed here)."""
    from threadpoolctl import threadpool_limits

    emb = np.random.default_rng(0).standard_normal((40, 8)).astype(np.float32)
    # one OpenMP thread: t-SNE's threads spin against the other test
    # workers' on a loaded machine (minutes instead of under a second)
    with threadpool_limits(limits=1):
        got = tv.reduce(emb, 2, method, seed=3)
        ref = jv.reduce(emb, 2, method, seed=3)
    assert got.shape == (40, 2)
    np.testing.assert_array_equal(got, ref)
    if method == "umap":
        pytest.importorskip("sklearn")
        np.testing.assert_array_equal(got, tv.reduce(emb, 2, "svd", seed=3))


def test_figures_write_pngs(tmp_path):
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((12, 6))
    labels = np.repeat([0, 1, 2], 4)
    assert tv.visualize_embeddings(emb, labels, convex_hull=True, legend=True, save=str(tmp_path / "e.png"))
    assert _png(tmp_path / "e.png")
    tv.plot_spectrogram(rng.standard_normal((50, 80)), save=str(tmp_path / "s.png"))
    assert _png(tmp_path / "s.png")
    scores = np.concatenate([rng.normal(0.7, 0.1, 40), rng.normal(0.2, 0.1, 60)])
    trials = (scores, np.r_[np.ones(40), np.zeros(60)])
    assert tv.plot_det_curve({"a": trials, "b": (scores * 0.5, trials[1])}, save=str(tmp_path / "d.png"))
    assert _png(tmp_path / "d.png")
    tv.play_audio(rng.standard_normal(160).astype(np.float32), 16000)


def _fake_wandb(monkeypatch):
    """A minimal in-process wandb stub recording the images it is given."""
    images = []
    run = types.SimpleNamespace(notes=None, log=lambda metrics, step=None: None,
                                save=lambda path: None, finish=lambda: None)
    fake = types.ModuleType("wandb")
    fake.Image = lambda path: images.append(path) or path
    fake.init = lambda **kw: run
    monkeypatch.setitem(sys.modules, "wandb", fake)
    return images


def test_figure_epoch_pushes_images_to_wandb_and_tensorboard(monkeypatch, tmp_path):
    """``training_loop(figures_path=...)``: each epoch's train and val
    figures land on disk, in W&B and in the TensorBoard event file."""
    from titanet_torch.data import ChunkConfig, DataLoader, SyntheticSpeakerDataset
    from titanet_torch.losses.heads import build_head
    from titanet_torch.models import DumbConvNet
    from titanet_torch.models.common import finish
    from titanet_torch.train.loop import training_loop
    from titanet_torch.train.state import create_train_state, make_optimizer
    from titanet_torch.utils.logging import TensorBoardLogger, WandbLogger
    from titanet_torch.utils.tb_events import read_events

    images = _fake_wandb(monkeypatch)
    ds = SyntheticSpeakerDataset(n_speakers=3, utterances_per_speaker=3, min_seconds=0.5, max_seconds=0.5)
    loader = DataLoader(ds, batch_size=4, chunk=ChunkConfig(enabled=False), prefetch=0)
    val = DataLoader(ds, batch_size=4, shuffle=False, chunk=ChunkConfig(enabled=False), prefetch=0)
    model = finish(DumbConvNet(hidden_size=8, embedding_size=16, n_layers=1), "cpu")
    state = create_train_state(model, build_head("ce", 16, 3, device="cpu"), make_optimizer())
    tb = TensorBoardLogger(str(tmp_path / "tb"))
    training_loop(
        "figrun", 1, state, loader, str(tmp_path / "ckpt"), frontend=TorchFrontend.from_ms(),
        val_loader=val, val_every=1, figures_path=str(tmp_path / "figs"), reduction_method="svd",
        checkpoints_frequency=None, wandb=WandbLogger(enabled=True), tb=tb,
    )
    tb.finish()
    for split in ("train", "val"):
        assert _png(tmp_path / "figs" / "figrun" / f"epoch_1_{split}.png")
        assert any(p.endswith(f"epoch_1_{split}.png") for p in images)
    (path,) = [os.path.join(tmp_path / "tb", f) for f in os.listdir(tmp_path / "tb")]
    tags = set()
    for event in read_events(path):
        tags |= set(event.get("images", {}))
    assert tags == {"train/embeddings", "val/embeddings"}


def test_profiling_helpers_on_the_cpu(tmp_path):
    from titanet_torch.utils.profiling import StepProfiler, device_memory_stats, span, trace

    p = StepProfiler()
    x = torch.ones(8, 8)
    with trace(str(tmp_path / "trace")):
        for _ in range(3):
            with p.step("mm", result_to_fence=lambda: y):
                with span("matmul"):
                    y = x @ x
    s = p.summary()
    assert set(s) == {"mm_ms_median"} and s["mm_ms_median"] >= 0.0
    spans_file, name = sorted(os.listdir(tmp_path / "trace"))  # the span log beside the Chrome trace
    assert name.endswith(".json") and "matmul" in open(tmp_path / "trace" / name).read()
    assert spans_file.endswith(".jsonl") and open(tmp_path / "trace" / spans_file).read().count('"matmul"') == 3
    assert device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def _toy_pair():
    """test_export.py's toy TitaNet in both packages, the same weights."""
    kw = dict(n_mega_blocks=1, encoder_hidden_size=32, encoder_output_size=48, embedding_size=16,
              attention_hidden_size=8, dropout=0.0)
    jmodel = JaxTitaNet(**kw)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((2, 101, 80)))
    tmodel = TorchTitaNet(**kw)
    load_jax_variables(tmodel, jax.tree_util.tree_map(np.asarray, variables["params"]),
                       jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    return jmodel, variables, tmodel.eval()


def test_export_round_trip_matches_the_live_model_and_jax(tmp_path):
    from titanet_torch.models import l2_normalize
    from titanet_torch.ops.frontend import log_mel_spectrogram
    from titanet_tpu.utils.export import export_titanet_embedder as jax_export
    from titanet_tpu.utils.export import load_embedder as jax_load

    jmodel, variables, tmodel = _toy_pair()
    wav = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    lengths = np.array([16000, 12000], np.int32)
    path = str(tmp_path / "embedder.pt2")
    blob = tx.export_titanet_embedder(tmodel, None, TorchFrontend.from_ms(), batch_size=2, num_samples=16000,
                                      path=path)
    assert open(path, "rb").read() == blob
    served = tx.load_embedder(path)
    out = served(torch.from_numpy(wav), torch.from_numpy(lengths)).numpy()
    assert out.shape == (2, 16)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, rtol=1e-5)
    with torch.no_grad():
        mel, _ = log_mel_spectrogram(torch.from_numpy(wav), TorchFrontend.from_ms(),
                                     lengths=torch.from_numpy(lengths))
        live = l2_normalize(tmodel(mel)).numpy()
    np.testing.assert_allclose(out, live, rtol=1e-5, atol=1e-6)
    # the JAX package's artifact on the same weights: cosine drift < 1e-5
    ref = np.asarray(jax_load(jax_export(jmodel, variables, JaxFrontend.from_ms(), batch_size=2,
                                         num_samples=16000))(jnp.asarray(wav), jnp.asarray(lengths)))
    cos = (out * ref).sum(-1) / np.linalg.norm(out, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert np.all(1.0 - cos < 1e-5)
    # a TrainState or a state_dict carries its weights in
    from titanet_torch.losses.heads import build_head
    from titanet_torch.train.state import create_train_state, make_optimizer

    st = create_train_state(tmodel, build_head("ce", 16, 3, device="cpu"), make_optimizer())
    from_state = tx.load_embedder(tx.export_titanet_embedder(tmodel, st, TorchFrontend.from_ms(), 2, 16000))
    np.testing.assert_array_equal(from_state(torch.from_numpy(wav), torch.from_numpy(lengths)).numpy(), out)


def test_fused_frontend_export_holds_the_log_mel_operator():
    """With ``use_pallas_fused`` the exported graph calls
    ``titanet_torch::log_mel_fused`` once (its CPU implementation is the
    plain version, so the artifact runs here and equals the live fused
    route); the default frontend's graph has no such node."""
    from titanet_torch.train.state import embed_step

    _, _, tmodel = _toy_pair()
    wav = (np.random.default_rng(1).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    for fused in (True, False):
        fe = TorchFrontend.from_ms(use_pallas_fused=fused)
        blob = tx.export_titanet_embedder(tmodel, None, fe, batch_size=2, num_samples=16000)
        program = torch.export.load(io.BytesIO(blob))
        ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
        hits = [t for t in ops if "titanet_torch" in str(t) and "log_mel_fused" in str(t)]
        assert len(hits) == (1 if fused else 0)
        with torch.no_grad():
            out = program.module()(torch.from_numpy(wav), torch.from_numpy(lengths))
        ref = embed_step(tmodel, wav, lengths, frontend=fe, device="cpu")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
