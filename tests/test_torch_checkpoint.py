"""Per-tile checkpoint and resume of the port's Gram build, automatic bond
dimension selection, and ``QMLTPU_CHI=auto`` in the CLI, against the JAX
reference on the CPU.

- the reference's own cases (``tests/test_checkpoint.py``) on the port: the
  checkpoint is removed at the end, and a partial one holding the first
  tile resumes to the full Gram (f64, 1e-12);
- a checkpoint the JAX package wrote (its build stopped after the first
  tile) resumes in the port, which then skips that tile;
- a checkpoint of another tile size is discarded;
- ``QMLTPU_CKPT_INTERVAL`` spaces the saves, and every save is atomic;
- ``choose_chi`` equals the reference's (its ``test_choose_chi`` settings);
- ``QMLTPU_CHI=auto`` probes once for the train and the test Gram of one
  ``cli.main`` run, and chooses the reference's chi."""

import dataclasses
import pathlib

import numpy as np
import pytest

import qml_cutensornet_tpu.models.gram as ref_gram
from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.utils.autotune import choose_chi as ref_choose_chi
from qml_cutensornet_tpu_torch.cli import _pipeline, main
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models import gram
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.utils.autotune import choose_chi
from qml_cutensornet_tpu_torch.utils.data import load_and_prepare, preprocess_elliptic

ROOT = pathlib.Path(__file__).resolve().parents[1]
NQ = 5


def _setup():
    rng = np.random.default_rng(0)
    emap = entanglement_graph(NQ, 2)
    X = rng.uniform(0, 2, size=(10, NQ))
    return emap, X


def _kwargs(tmp_path):
    return dict(cfg=SimConfig(chi=4, precision="f64"), sim_batch=4, tile=4, checkpoint=True,
                checkpoint_dir=str(tmp_path), device="cpu")


def _count_tiles(monkeypatch):
    calls = []
    real = gram.tile_overlaps_sq

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gram, "tile_overlaps_sq", counted)
    return calls


def test_checkpoint_resume(tmp_path, monkeypatch):
    """The reference's test_checkpoint_resume on the port."""
    emap, X = _setup()
    ansatz = KernelStateAnsatz(NQ, 1, 0.8, emap)
    kwargs = _kwargs(tmp_path)
    calls = _count_tiles(monkeypatch)
    K_full = gram.build_kernel_matrix(ansatz, X, info_file=str(tmp_path / "run"), **kwargs)
    assert not list(tmp_path.glob("checkpoint_*.npy"))  # removed at the end
    assert not list(tmp_path.glob("*.tmp.npy"))
    full_tiles = len(calls)
    assert full_tiles == 6  # 3 x 3 tiles of 4 (12 padded rows), lower triangle

    partial = np.zeros((12, 12))
    partial[:4, :4] = K_full[:4, :4]
    np.save(tmp_path / "checkpoint_run.npy", partial)
    calls.clear()
    K_resumed = gram.build_kernel_matrix(ansatz, X, info_file=str(tmp_path / "run"), **kwargs)
    assert len(calls) == full_tiles - 1
    np.testing.assert_allclose(K_resumed, K_full, atol=1e-12)
    assert not list(tmp_path.glob("checkpoint_*.npy"))


def test_checkpoint_written_by_reference_resumes(tmp_path, monkeypatch):
    """The JAX package's build stops after its first tile, leaving its own
    checkpoint; the port resumes from that file."""
    emap, X = _setup()
    real = ref_gram.tile_overlaps_sq
    done = []

    def stop_after_first(*a, **k):
        if done:
            raise KeyboardInterrupt("stopped after the first tile")
        done.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ref_gram, "tile_overlaps_sq", stop_after_first)
    rcfg = RefConfig(chi=4, precision="f64")
    with pytest.raises(KeyboardInterrupt):
        ref_gram.build_kernel_matrix(RefAnsatz(NQ, 1, 0.8, emap), X,
                                     info_file=str(tmp_path / "run"), cfg=rcfg, sim_batch=4,
                                     tile=4, checkpoint=True, checkpoint_dir=str(tmp_path))
    ckpt = np.load(tmp_path / "checkpoint_run.npy")
    assert ckpt.shape == (12, 12) and (ckpt[:4, :4] != 0).all() and (ckpt[4:] == 0).all()

    ansatz = KernelStateAnsatz(NQ, 1, 0.8, emap)
    kwargs = _kwargs(tmp_path)
    kwargs["cfg"] = SimConfig.from_reference(dataclasses.asdict(rcfg))
    calls = _count_tiles(monkeypatch)
    K_resumed = gram.build_kernel_matrix(ansatz, X, info_file=str(tmp_path / "run"), **kwargs)
    assert len(calls) == 5  # the reference's tile is not recomputed
    assert not list(tmp_path.glob("checkpoint_*.npy"))
    K_full = gram.build_kernel_matrix(ansatz, X, info_file=str(tmp_path / "full"), **kwargs)
    np.testing.assert_allclose(K_resumed, K_full, atol=1e-12)


def test_checkpoint_of_another_tile_size_is_discarded(tmp_path, monkeypatch, capsys):
    emap, X = _setup()
    ansatz = KernelStateAnsatz(NQ, 1, 0.8, emap)
    kwargs = _kwargs(tmp_path)
    K_full = gram.build_kernel_matrix(ansatz, X, info_file=str(tmp_path / "run"), **kwargs)
    # A tile of 6 pads to 12 x 12 too; a tile of 8 pads to 16 x 16: written
    # under tile 8, nonzero corners everywhere, it must not be trusted.
    np.save(tmp_path / "checkpoint_run.npy", np.full((16, 16), 7.0))
    calls = _count_tiles(monkeypatch)
    K = gram.build_kernel_matrix(ansatz, X, info_file=str(tmp_path / "run"), loglevel=20,
                                 **kwargs)
    assert "discarding it" in capsys.readouterr().out
    assert len(calls) == 6
    np.testing.assert_allclose(K, K_full, atol=1e-12)


@pytest.mark.parametrize("interval,saves", [("0", 6), ("1e9", 1)])
def test_checkpoint_interval_and_atomic_save(tmp_path, monkeypatch, interval, saves):
    """QMLTPU_CKPT_INTERVAL spaces the saves (the first tile always saves);
    each save writes a tmp file and renames it over the checkpoint."""
    monkeypatch.setenv("QMLTPU_CKPT_INTERVAL", interval)
    emap, X = _setup()
    written = []
    real_save = np.save

    def save(path, arr):
        written.append(pathlib.Path(path).name)
        real_save(path, arr)

    monkeypatch.setattr(gram.np, "save", save)
    gram.build_kernel_matrix(KernelStateAnsatz(NQ, 1, 0.8, emap), X,
                             info_file=str(tmp_path / "run"), **_kwargs(tmp_path))
    assert written == ["checkpoint_run.tmp.npy"] * saves
    assert not list(tmp_path.glob("*.npy"))


def test_choose_chi_matches_reference():
    """The reference's test_choose_chi settings: 8 qubits, d 3, f64."""
    rng = np.random.default_rng(1)
    nq = 8
    emap = entanglement_graph(nq, 3)
    X = rng.uniform(0, 2, size=(3, nq))
    cfg = SimConfig(precision="f64")
    chi = choose_chi(KernelStateAnsatz(nq, 2, 1.0, emap).schedule, X, cfg, chi_start=2,
                     chi_max=16, device="cpu")
    want = ref_choose_chi(RefAnsatz(nq, 2, 1.0, emap).schedule, X, RefConfig(precision="f64"),
                          chi_start=2, chi_max=16)
    assert chi == want and chi in (8, 16)
    # a target below the first probe's fidelity stops at chi_start
    assert choose_chi(KernelStateAnsatz(nq, 2, 1.0, emap).schedule, X, cfg, chi_start=2,
                      fidelity_target=0.0, device="cpu") == 2


def test_cli_chi_auto_probes_once(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(_pipeline, "_auto_chi_cache", {})
    for key, value in (("QMLTPU_DEVICE", "cpu"), ("QMLTPU_CHI", "auto"),
                       ("QMLTPU_AUTO_CHI_MAX", "16")):
        monkeypatch.setenv(key, value)
    preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), "datasets/v1.csv")
    argv = ["main", "GPU", "6", "1", "1.0", "2", "5", "5", "1", "v1.csv"]
    K_train, K_test, _, _ = main.main(argv)
    out = capsys.readouterr().out
    assert out.count("QMLTPU_CHI=auto selected chi=") == 1
    probes = [line for line in out.splitlines() if line.startswith("choose_chi:")]
    x_train = load_and_prepare("datasets/v1.csv", 6, 5, 5, 1)[0]
    params = _pipeline.parse_argv(argv)
    base = dataclasses.replace(_pipeline.sim_config(params, sample_features=x_train), chi=8,
                               oversample=0, tile_block=2)
    want = ref_choose_chi(RefAnsatz(6, 1, 1.0, params.entanglement_map).schedule, x_train[:8],
                          RefConfig(**{k: v for k, v in dataclasses.asdict(base).items()}),
                          fidelity_target=1.0 - 1e-9, chi_max=16)
    assert f"QMLTPU_CHI=auto selected chi={want}" in out
    assert len(probes) == int(np.log2(want // 8)) + 1
    assert K_train.shape == (8, 8) and K_test.shape == (2, 8)
