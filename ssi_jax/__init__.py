"""ssi_jax — speech-integration framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the reference
speech-integration stack (Llama 3.2 + discrete speech units): tokenizer/embedding
extension, CPT/SFT training with exact-resume HF-format checkpoints, deterministic
host data pipelines, batched generation, and WER evaluation.
"""

import os

__version__ = "0.1.0"

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_COMPILE_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> str:
    """The persistent compilation cache directory every process of this repo uses.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself); otherwise
    the cache lives at the one fixed path ``<repo>/.jax_cache``, so repeated
    launches from the same checkout find each other's compiled programs.
    """
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE_DIR


def _enable_persistent_compilation_cache() -> None:
    """Point JAX at the cache before any program compiles.

    Import-time config is safe: it only sets the cache path (no backend
    initialization happens here).
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)


_enable_persistent_compilation_cache()
