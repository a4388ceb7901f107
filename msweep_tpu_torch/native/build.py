"""Build the native C++ fast paths ahead of time: `python -m msweep_tpu_torch.native.build`.

Import of msweep_tpu_torch.native builds lazily on first use; this entry point
exists for CI and packaging so a broken toolchain is reported loudly
instead of silently falling back to numpy at runtime.
"""

from __future__ import annotations

import sys


def main() -> int:
    try:
        from . import _lib  # noqa: F401  (import triggers the build)
    except ImportError as e:
        print(f"native build FAILED: {e}", file=sys.stderr)
        return 1
    from . import _SO

    print(f"native library built: {_SO}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
