"""Test fixtures.

Forces JAX onto a virtual 8-device CPU platform (before any jax import) so the
sharding/mesh paths run without accelerator hardware — the analog of the
reference's CPU-only CI (ref: .github/workflows/tests.yml:9-24). Tests that need
the card carry the ``gpu`` marker and request the ``gpu_device`` fixture; run them
on a GPU host with ``SSI_JAX_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``.
"""

import os

if not os.environ.get("SSI_JAX_TESTS_ON_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    # jaxtyping's pytest plugin imports jax before this conftest runs, freezing the
    # platform config from the original environment — env vars alone are too late.
    import jax

    jax.config.update("jax_platforms", "cpu")

# Persistent compile cache (content-keyed on the HLO, so always safe): most of
# the suite's cost is XLA re-compiling near-identical tiny-model programs across
# modules — warm runs skip them. The directory is the package's one cache path
# (ssi_jax.compile_cache_dir); disable with SSI_JAX_TESTS_NO_CACHE=1 to measure
# cold-compile behavior.
import jax  # noqa: E402

import ssi_jax  # noqa: E402,F401  (sets the cache directory before any compile)

if os.environ.get("SSI_JAX_TESTS_NO_CACHE"):
    jax.config.update("jax_enable_compilation_cache", False)
else:
    # persist every program: the suite's cost is hundreds of small compiles,
    # each below the default 1 s persistence threshold
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import pytest  # noqa: E402

from tests import helpers  # noqa: E402


@pytest.fixture()
def gpu_device():
    """The first CUDA device; skips (with the reason) when this process has none.

    Decided here, at test time, never while a module is imported: every xdist
    worker must collect the same tests.
    """
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with SSI_JAX_TESTS_ON_GPU=1 on a GPU host)")
    return devices[0]


@pytest.fixture()
def tiny_tokenizer_path(tmp_path):
    path = tmp_path / "tokenizer.model"
    helpers.write_tiny_tokenizer(path)
    return path


@pytest.fixture()
def tiny_extended_tokenizer_path(tmp_path):
    """256-byte base vocab extended with 16 DSU + 2 modality tokens (vocab 274+256)."""
    from ssi_jax.extend import extend_tiktoken

    path = tmp_path / "tokenizer.model"
    helpers.write_tiny_tokenizer(path)
    extend_tiktoken(16, True, path, path)
    return path


@pytest.fixture()
def tiny_model_dir(tmp_path):
    """Self-contained tiny extended HF model dir (weights + configs + tokenizer)."""
    return helpers.make_tiny_hf_checkpoint(tmp_path / "model")


@pytest.fixture()
def synthetic_data(monkeypatch):
    """Patch HF dataset loading with synthetic aligned speech-text rows."""
    import datasets as hfd

    import ssi_jax.data as data_mod

    cpt_rows = helpers.synthetic_cpt_rows(64)
    sft_rows = helpers.synthetic_sft_rows(64)

    def fake_load(source, **kw):
        rows = sft_rows if "sft" in str(source) else cpt_rows
        return hfd.Dataset.from_list(rows)

    def fake_subset(source, n_samples, filter_fn=None, **kw):
        rows = sft_rows if "sft" in str(source) else cpt_rows
        if filter_fn is not None:  # mirror the real filter-before-take semantics
            rows = [r for r in rows if filter_fn(r)]
        return hfd.Dataset.from_list(rows[:n_samples])

    monkeypatch.setattr(data_mod, "load_hf_dataset", fake_load)
    monkeypatch.setattr(data_mod, "load_dataset_subset", fake_subset)
    return {"cpt": cpt_rows, "sft": sft_rows}
