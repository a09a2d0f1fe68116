"""The port's serving entry points (``python -m titanet_torch infer |
trials | diarize``, titanet_torch/cli.py) on the CPU, from a port
checkpoint whose weights come from a JAX train state
(``load_jax_train_state`` + ``checkpoint.save_checkpoint``): ``infer``
against the JAX ``SpeakerEmbedder`` on the same weights and WAVs, the
``trials`` EER against JAX's ``evaluate_trials``, the ``diarize`` RTTM read
back, the options that are not ported, and CUDA without a card."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import cosine
from titanet_torch import cli
from titanet_torch.data.audio_io import write_wav
from titanet_torch.train import checkpoint as ckpt
from titanet_torch.train import diarize as td
from titanet_torch.train.loop import infer as torch_infer
from titanet_torch.utils.weights import load_jax_train_state
from titanet_tpu.data.audio_io import read_audio as jax_read_audio
from titanet_tpu.data.loader import _resample_host as jax_resample
from titanet_tpu.losses.heads import build_head as jax_build_head
from titanet_tpu.models import get_titanet as jax_get_titanet
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.train import state as js
from titanet_tpu.train.extractor import SpeakerEmbedder as JaxEmbedder
from titanet_tpu.train.trials import evaluate_trials as jax_evaluate_trials

CONFIG = {
    "dataset": {"name": "synthetic", "synthetic_speakers": 4, "synthetic_utterances": 4},
    "validation": {"batch_size": 4, "num_utterances_per_speaker": 1},
    "test": {"num_speakers": 2, "num_utterances_per_speaker": 2},
    "titanet": {"model_size": "s", "n_mega_blocks": 1, "attention_hidden_size": 16},
}
SR = 16000


def _speaker(freq, seconds, seed, sr=SR):
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    wav = 0.3 * np.sin(2 * np.pi * freq * t) + 0.2 * np.sin(2 * np.pi * 2.7 * freq * t + seed)
    return (wav + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A port checkpoint of TitaNet-S (1 mega-block) from JAX weights, the
    configs that rebuild it (YAML and JSON), and WAVs of 3 'speakers':
    2 files each under utts/ (1.1-2.6 s), one of them stereo at 8 kHz."""
    root = tmp_path_factory.mktemp("entry")
    yml = root / "params.yml"
    yml.write_text("\n".join(f"{k}: {json.dumps(v)}" for k, v in CONFIG.items()) + "\n")
    (root / "params.json").write_text(json.dumps(CONFIG))
    cfg = cli.load_config(str(yml))
    n_speakers = cli._datasets(cfg, True)[3]
    jmodel = jax_get_titanet(model_size="s", n_mega_blocks=1, attention_hidden_size=16)
    jstate = js.create_train_state(jax.random.key(3), jmodel, jax_build_head("ce", 192, n_speakers),
                                   js.make_optimizer(), jnp.zeros((2, 101, 80)), n_speakers)
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    params, stats = tree(jstate.params), tree(jstate.batch_stats)
    _, _, state = cli._new_state(cfg, n_speakers, torch.device("cpu"))
    load_jax_train_state(state.model, state.head, params, stats)
    run = str(root / "run")
    ckpt.save_checkpoint(run, 1, state)
    os.makedirs(root / "utts")
    files = []
    for s, freq in enumerate((140.0, 310.0, 620.0)):
        for i in range(2):
            path = str(root / "utts" / f"s{s}_{i}.wav")
            if (s, i) == (2, 1):  # stereo at 8 kHz: downmixed and resampled
                wav8 = _speaker(freq, 1.4, 10 * s + i, sr=8000)
                write_wav(path, np.stack([wav8, 0.5 * wav8]), 8000)
            else:
                write_wav(path, _speaker(freq, 1.1 + 0.5 * i + 0.3 * s, 10 * s + i), SR)
            files.append(path)
    jemb = JaxEmbedder(jmodel, params["backbone"], stats, JaxFrontend.from_ms())
    return dict(root=root, yml=str(yml), json=str(root / "params.json"), run=run, files=files,
                jemb=jemb, cfg=cfg)


def _jax_wav(path):
    wav, sr = jax_read_audio(path)
    wav = np.asarray(wav, np.float32).mean(axis=0)
    return jax_resample(wav, sr, SR) if sr != SR else wav


def test_infer_audio_matches_the_jax_embedder(setup):
    """``infer --audio <dir>``: the file stems as labels, unit-norm rows
    within cosine 1 - 1e-5 of JAX's SpeakerEmbedder on the same weights
    (the port's fused route in its plain version vs JAX's plain frontend);
    ``-n``/``--split`` without ``--audio`` equals loop.infer."""
    out = str(setup["root"] / "a.npz")
    emb, labels = cli.main(["infer", "-p", setup["yml"], "-c", setup["run"], "--audio",
                            str(setup["root"] / "utts"), "-o", out, "--device", "cpu"])
    saved = np.load(out)
    np.testing.assert_array_equal(saved["embeddings"], emb)
    assert list(saved["labels"]) == [os.path.splitext(os.path.basename(p))[0] for p in setup["files"]]
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)
    ref = setup["jemb"].embed([_jax_wav(p) for p in setup["files"]])
    assert (1.0 - cosine(emb, ref)).max() < 1e-5
    emb, speakers = cli.main(["infer", "-p", setup["yml"], "-c", setup["run"], "-n", "3", "--device", "cpu"])
    state, frontend, _ = cli._restore_for_eval(setup["cfg"], cli._datasets(setup["cfg"], True)[3],
                                               setup["run"], None, "cpu")
    want, want_spk = torch_infer(state, cli._datasets(setup["cfg"], True)[2], [0, 1, 2], frontend=frontend,
                                 batch_size=4)
    np.testing.assert_array_equal(emb, want)
    assert list(speakers) == want_spk


def test_trials_eer_equals_jax(setup, tmp_path):
    """``trials`` on every pair of the 6 files (VoxCeleb format, then Kaldi
    format): the same EER as JAX's evaluate_trials through the JAX
    embedder, the same scores from both formats, and an S-norm run from
    an ``infer -o`` cohort."""
    names = [os.path.relpath(p, setup["root"]) for p in setup["files"]]
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    same = lambda a, b: os.path.basename(a)[:2] == os.path.basename(b)[:2]  # noqa: E731
    vox, kaldi = tmp_path / "veri.txt", tmp_path / "trials"
    vox.write_text("".join(f"{int(same(a, b))} {a} {b}\n" for a, b in pairs))
    kaldi.write_text("".join(f"{a} {b} {'target' if same(a, b) else 'nontarget'}\n" for a, b in pairs))
    base = ["trials", "-p", setup["yml"], "-c", setup["run"], "--audio-root", str(setup["root"]), "--device", "cpu"]
    got = cli.main(base + ["--trial-file", str(vox), "-o", str(tmp_path / "s1.txt")])
    got_k = cli.main(base + ["--trial-file", str(kaldi), "-o", str(tmp_path / "s2.txt")])
    ref = jax_evaluate_trials(str(vox), setup["jemb"], audio_root=str(setup["root"]))
    assert (got["n_trials"], got["n_target"], got["n_files"]) == (15, 3, 6)
    assert got["eer"] == ref["eer"] == got_k["eer"]
    s1 = [line.split() for line in (tmp_path / "s1.txt").read_text().splitlines()]
    s2 = [line.split() for line in (tmp_path / "s2.txt").read_text().splitlines()]
    assert s1 == s2 and [r[:2] for r in s1] == [list(p) for p in pairs]
    cohort = str(tmp_path / "cohort.npz")
    cli.main(["infer", "-p", setup["yml"], "-c", setup["run"], "--audio", *setup["files"][:4], "-o", cohort,
              "--device", "cpu"])
    normed = cli.main(base + ["--trial-file", str(vox), "--cohort", cohort, "--cohort-topk", "2"])
    assert 0.0 <= normed["eer"] <= 1.0 and np.isfinite(normed["min_cllr"])


def test_diarize_writes_an_rttm_that_reads_back(setup, tmp_path):
    """``diarize`` (config from the JSON file) on a 6 s conversation of
    two 'speakers' in turns, NME-SC and AHC with VAD: the RTTM reads back
    to the returned segments."""
    conv = str(tmp_path / "conv.wav")
    write_wav(conv, np.concatenate([_speaker(140.0, 2, 1), _speaker(620.0, 2, 2), _speaker(140.0, 2, 3)]), SR)
    rttm = str(tmp_path / "out.rttm")
    for extra in (["--known-k", "2"], ["--clustering", "ahc", "--vad"]):
        results = cli.main(["diarize", "-p", setup["json"], "-c", setup["run"], "--audio", conv, "--rttm", rttm,
                            "--device", "cpu", *extra])
        segs = results[conv]
        assert segs and all(isinstance(s, td.Segment) for s in segs)
        back = td.read_rttm(rttm)["conv"]
        assert len(back) == len(segs)
        for s, b in zip(segs, back):
            assert abs(s.start - b.start) < 1e-3 and abs(s.end - b.end) < 1e-3 and s.speaker == b.speaker


def test_figures_are_not_ported_and_cuda_needs_a_card(setup, tmp_path):
    """``infer --fig`` writes the projection figure and ``trials --det-out``
    the DET curve (matplotlib is installed here); every command refuses
    the default ``--device cuda`` without a card."""
    base = ["-p", setup["yml"], "-c", setup["run"], "--device", "cpu"]
    fig, det = tmp_path / "f.png", tmp_path / "d.png"
    cli.main(["infer", *base, "--audio", *setup["files"][:3], "--fig", str(fig)])
    assert fig.stat().st_size > 0 and fig.read_bytes()[:4] == b"\x89PNG"
    (tmp_path / "t.txt").write_text(
        f"1 {setup['files'][0]} {setup['files'][1]}\n0 {setup['files'][0]} {setup['files'][2]}\n"
    )
    cli.main(["trials", *base, "--trial-file", str(tmp_path / "t.txt"), "--det-out", str(det)])
    assert det.stat().st_size > 0 and det.read_bytes()[:4] == b"\x89PNG"
    for cmd in (["infer", "--audio", setup["files"][0]], ["trials", "--trial-file", str(tmp_path / "t.txt")],
                ["diarize", "--audio", setup["files"][0]]):
        if not torch.cuda.is_available():  # --device defaults to cuda
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main([cmd[0], "-p", setup["yml"], "-c", setup["run"], *cmd[1:]])
