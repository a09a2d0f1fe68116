"""Step capture (``titanet_torch/train/capture.py``) and the compilation
cache on the CPU: the steps run eagerly here and equal ``capture=False``,
``capture=True`` raises, the graph cache's key, the kernels' build
directory, and the CLI's ``generic.compilation_cache_dir``. The graphs
themselves run on the card (``tests/test_torch_cuda.py``)."""

import gc
import json

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import small_titanet_pair
from titanet_torch import cli
from titanet_torch.losses import build_head
from titanet_torch.models.quantized import quantize_titanet
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.ops.kernels import _build, launch_counters
from titanet_torch.train import capture
from titanet_torch.train import checkpoint as ckpt
from titanet_torch.train import state as ts
from titanet_torch.train.extractor import SpeakerEmbedder
from titanet_torch.utils import enable_compilation_cache

FE = FrontendConfig.from_ms(use_pallas_fused=True)


def _batch(seed=0, b=3, t=8000):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    lengths = np.array([t, t - 1500, 3000][:b], np.int32)
    return wav, lengths


@pytest.fixture(scope="module")
def model():
    return small_titanet_pair(None, seed=4)[2]


def _steps(model):
    """Each captured step as ``name -> fn(capture)``."""
    wav, lengths = _batch()
    head = build_head("ce", 192, 5, device="cpu")
    state = ts.TrainState(model=model, head=head, optimizer=None, opt_state=None, generator=None,
                           aug_generator=None, noise_generator=None)
    qtree = quantize_titanet(model)
    speakers = np.array([0, 3, 1])
    return {
        "embed_step": lambda c: ts.embed_step(model, wav, lengths, frontend=FE, device="cpu", capture=c),
        "embed_step_masked": lambda c: ts.embed_step(model, wav, lengths, frontend=FE, masked=True,
                                                     device="cpu", capture=c),
        "embed_step_quantized": lambda c: ts.embed_step_quantized(qtree, wav, lengths, frontend=FE, masked=True,
                                                                  device="cpu", capture=c),
        "eval_step": lambda c: ts.eval_step(state, wav, lengths, speakers, frontend=FE, capture=c),
        "embedder": lambda c: SpeakerEmbedder(model, FE, buckets=[8000, 16000], batch_size=4, device="cpu",
                                              capture=c).embed([wav[0], wav[1, :5000], wav[2, :2000]]),
    }


@pytest.mark.parametrize("name", ["embed_step", "embed_step_masked", "embed_step_quantized", "eval_step",
                                  "embedder"])
def test_cpu_steps_run_eagerly_and_equal_capture_false(model, name):
    step = _steps(model)[name]
    captures, n_graphs = capture.GRAPHS.captures, len(capture.GRAPHS)
    got, want = step(None), step(False)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert torch.equal(a, b)
        assert a.device.type == "cpu"
    assert (capture.GRAPHS.captures, len(capture.GRAPHS)) == (captures, n_graphs)


@pytest.mark.parametrize("name", ["embed_step", "embed_step_quantized", "eval_step", "embedder"])
def test_capture_true_on_the_cpu_raises(model, name):
    with pytest.raises(ValueError, match="step capture needs a CUDA device"):
        _steps(model)[name](True)


def test_warmup_runs_every_bucket_largest_first(model, monkeypatch):
    """One padded batch a bucket, the largest first (a smaller graph's
    capture reuses the pool blocks a larger one freed)."""
    embedder = SpeakerEmbedder(model, FE, buckets=[16000, 8000, 24000], batch_size=2, device="cpu")
    seen = []
    monkeypatch.setattr(embedder, "_embed_padded", lambda wavs, bucket: seen.append((len(wavs), bucket)))
    embedder.warmup()
    assert seen == [(1, 24000), (1, 16000), (1, 8000)]


def test_wanted_follows_the_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert capture.wanted(None, cuda) and not capture.wanted(None, cpu)
    assert not capture.wanted(False, cuda) and not capture.wanted(False, cpu)
    assert capture.wanted(True, cuda)


def test_int16_pcm_is_dequantized_inside_the_step(model, monkeypatch):
    """The int16 wire format reaches the step as int16 (on the card it is a
    graph input of its own dtype) and the step dequantizes it."""
    wav, lengths = _batch(1)
    pcm = np.round(wav * 32767).astype(np.int16)
    seen = []
    real = ts._dequantize_waveform

    def spy(w):
        seen.append(w.dtype)
        return real(w)

    monkeypatch.setattr(ts, "_dequantize_waveform", spy)
    a = ts.embed_step(model, pcm, lengths, frontend=FE, device="cpu")
    b = ts.embed_step(model, pcm.astype(np.float32) / 32768.0, lengths, frontend=FE, device="cpu")
    assert seen == [torch.int16, torch.float32]
    torch.testing.assert_close(a, b)
    key16 = capture.StepGraphs.key("embed_step", (FE, False), (model,), (torch.from_numpy(pcm), None))
    key32 = capture.StepGraphs.key("embed_step", (FE, False), (model,), (torch.from_numpy(wav), None))
    assert key16 != key32


def _key(model, wav, lengths, *, frontend=FE, masked=False):
    return capture.StepGraphs.key("embed_step", (frontend, masked), (model,), (wav, lengths))


@pytest.mark.parametrize("change", ["shape", "lengths_shape", "dtype", "masked", "frontend", "replaced",
                                    "other_model"])
def test_key_tells_apart(change):
    _, _, m = small_titanet_pair(None, seed=5)
    wav, lengths = (torch.from_numpy(x) for x in _batch(2))
    base = _key(m, wav, lengths)
    assert _key(m, wav.clone(), lengths.clone()) == base  # other tensors of the same kind
    if change == "shape":
        other = _key(m, wav[:, :7000].contiguous(), lengths)
    elif change == "lengths_shape":
        other = _key(m, wav[:2], lengths[:2])
    elif change == "dtype":
        other = _key(m, (wav * 32767).to(torch.int16), lengths)
    elif change == "masked":
        other = _key(m, wav, lengths, masked=True)
    elif change == "frontend":
        other = _key(m, wav, lengths, frontend=FE._replace(precision="default"))
    elif change == "replaced":
        m.to(torch.bfloat16)  # every parameter replaced: new addresses and dtype
        other = _key(m, wav, lengths)
    else:
        other = _key(small_titanet_pair(None, seed=5)[2], wav, lengths)
    assert other != base


def test_key_keeps_parameters_updated_in_place():
    _, _, m = small_titanet_pair(None, seed=6)
    _, _, donor = small_titanet_pair(None, seed=7)
    wav, lengths = (torch.from_numpy(x) for x in _batch(3))
    base = _key(m, wav, lengths)
    m.load_state_dict(donor.state_dict())
    with torch.no_grad():
        next(m.parameters()).mul_(0.5)
    assert _key(m, wav, lengths) == base


def test_owned_tensors_cover_a_module_and_a_quantized_tree(model):
    assert len(capture.owned_tensors(model)) == len(list(model.parameters())) + len(list(model.buffers()))
    qtree = quantize_titanet(model)
    tensors = capture.owned_tensors(qtree)
    assert any(t is qtree.prolog_kernel for t in tensors)
    n_leaves = sum(isinstance(x, torch.Tensor) for x in torch.utils._pytree.tree_leaves(
        [getattr(qtree, f) for f in qtree.__dataclass_fields__]))
    assert len(tensors) >= n_leaves > 10


def test_graphs_of_a_collected_owner_are_dropped():
    graphs = capture.StepGraphs()
    owner, keeper = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    for i, o in enumerate((owner, keeper)):
        graphs._graphs[("step", i)] = capture.StepGraph(None, (), [], None, (), 0.0, (id(o),))
        graphs._watch([o])
    del owner
    gc.collect()
    graphs._collect_dead()
    assert list(graphs._graphs) == [("step", 1)]


def test_launch_counters_list_every_wrapper_counter():
    from titanet_torch.ops.kernels import dwconv, megablock, melspec, pool

    listed = {(id(obj), attr) for obj, attr in launch_counters()}
    for mod in (melspec, pool, dwconv, megablock):
        for obj in vars(mod).values():
            for attr in ("launches", "tc_launches", "dmma_launches"):
                if callable(obj) and isinstance(getattr(obj, attr, None), int):
                    assert (id(obj), attr) in listed, (obj.__name__, attr)


def test_enable_compilation_cache_points_the_kernel_build_there(tmp_path, monkeypatch):
    """The build directory moves into the cache; a library another process
    built there under the sources' digest is found and nvcc does not run;
    an edited source gets another name."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored after the test

    def no_nvcc():
        raise AssertionError("nvcc ran")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    cache = tmp_path / "a" / "cache"
    enable_compilation_cache(str(cache))
    enable_compilation_cache(str(cache))  # safe to call twice
    assert cache.is_dir() and _build.BUILD_DIR == cache.resolve()
    paths = {name: _build.library_path(name)[1] for name in _build.SOURCES}
    assert all(p.parent == cache.resolve() for p in paths.values())
    for p in paths.values():
        p.write_bytes(b"built by another process")
    assert _build.build() == {}
    edited = tmp_path / "csrc"
    edited.mkdir()
    for f in _build.CSRC_DIR.iterdir():
        (edited / f.name).write_bytes(f.read_bytes())
    (edited / "logmel.cu").write_text((_build.CSRC_DIR / "logmel.cu").read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC_DIR", edited)
    assert _build.library_path("logmel")[1] != paths["logmel"]
    assert _build.library_path("attn_pool")[1] == paths["attn_pool"]


CLI_CONFIG = {
    "dataset": {"name": "synthetic", "synthetic_speakers": 4, "synthetic_utterances": 4},
    "validation": {"batch_size": 4, "num_utterances_per_speaker": 1},
    "test": {"enabled": False, "num_speakers": 2, "num_utterances_per_speaker": 2},
    "titanet": {"model_size": "s", "n_mega_blocks": 1, "attention_hidden_size": 16},
    "training": {"epochs": 1, "batch_size": 4},
    "augmentation": {"enable": []},
}


@pytest.mark.parametrize("command", ["train", "infer"])
def test_cli_reads_the_compilation_cache_dir(tmp_path, monkeypatch, command):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    called = []
    monkeypatch.setattr(cli, "enable_compilation_cache", lambda d: (called.append(d), enable_compilation_cache(d)))
    cache = tmp_path / "xla_cache"
    conf = {**CLI_CONFIG, "generic": {"compilation_cache_dir": str(cache)},
            "training": {**CLI_CONFIG["training"], "checkpoints_path": str(tmp_path / "ck")}}
    params = tmp_path / "params.json"
    params.write_text(json.dumps(conf))
    cfg = cli.load_config(str(params))
    if command == "train":
        cli.main(["train", "-p", str(params), "--device", "cpu"])
    else:
        n_speakers = cli._datasets(cfg, True)[3]
        _, _, state = cli._new_state(cfg, n_speakers, torch.device("cpu"))
        ckpt.save_checkpoint(str(tmp_path / "run"), 1, state)
        wav = _batch(5, b=1, t=20000)[0][0]
        from titanet_torch.data.audio_io import write_wav

        write_wav(str(tmp_path / "u.wav"), wav, 16000)
        emb, _ = cli.main(["infer", "-p", str(params), "-c", str(tmp_path / "run"), "--audio",
                           str(tmp_path / "u.wav"), "--device", "cpu"])
        assert emb.shape == (1, 192)
    assert called and set(called) == {str(cache)}
    assert cache.is_dir() and _build.BUILD_DIR == cache.resolve()
