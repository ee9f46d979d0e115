"""Ahead-of-time build of the native host kernels.

    python tools/build_native.py

Equivalent to the lazy first-use build in libpll2_jax/native/__init__.py.
"""
import sys

sys.path.insert(0, ".")

from libpll2_jax import native  # noqa: E402

if __name__ == "__main__":
    ok = native.build()
    print("built libpllnative.so" if ok else "build FAILED (g++ missing?)")
    sys.exit(0 if ok else 1)
