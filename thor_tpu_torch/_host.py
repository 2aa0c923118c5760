"""The host tier of `thor_tpu`, loaded without JAX.

The C block parser, the bit reader, the normative tables, the frame
buffers, the numpy spec and the decoder's syntax walk in `thor_tpu/` do
not import JAX, but the package's `__init__` does (it enables x64 and
sets up XLA's compile cache).  This module loads those files from the
`thor_tpu/` directory under a private package name, `ALIAS`, so that
`thor_tpu/__init__.py` never runs and a machine without JAX can use
them.  Relative imports inside the loaded files resolve inside the
alias, and the real `thor_tpu` package, where one is imported beside the
port, is a separate set of module objects that the alias never shadows.

Module layout under the alias:

* `ALIAS`, `ALIAS.dec` and `ALIAS.ops` are bare packages whose search
  path is the matching `thor_tpu/` directory.  Their `__init__` files are
  not executed.
* `ALIAS.tables`, `.bitstream`, `.frame`, `.spec.*`, `._native`,
  `.dec.native_parse`, `.dec.decoder` and `.cli` are the `thor_tpu`
  files themselves, loaded on first import.

`ALIAS._native` builds its library into `BUILD_DIR` (not next to its
sources) under a temporary name that is renamed into place.

Substitutions (the decoder imports these lazily, and the originals
import JAX at the top):

* `ALIAS.dec.device_pixels` is `thor_tpu_torch.dec.device_pixels`
  (reached from `decoder.py`'s `FramePlan` construction);
* `ALIAS.dec.device_frame` is `thor_tpu_torch.dec.device_frame`;
* `ALIAS.ops.filters` is `thor_tpu_torch.ops.filters`;
* `ALIAS.ops.tempinterp` is `thor_tpu_torch.ops.tempinterp`, whose entry
  points raise `NotImplementedError` (temporal interpolation is not
  ported yet);
* `ALIAS.dec.decode_stream` is `thor_tpu_torch.dec.decoder.decode_stream`,
  so `cli.main_dec` decodes through the port.
"""
from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import os
import sys
import types

ALIAS = "_thor_tpu_host"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_REPO, "thor_tpu")
# what the port builds: the CUDA kernels and its copy of the C host tier
BUILD_DIR = os.path.join(_REPO, "build", "thor_tpu_torch")


def _bare_package(name: str, path: str) -> types.ModuleType:
    spec = importlib.machinery.ModuleSpec(name, None, is_package=True)
    spec.submodule_search_locations = [path]
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    return mod


def _load(name: str) -> types.ModuleType:
    return importlib.import_module(f"{ALIAS}.{name}")


_bare_package(ALIAS, SRC)
_bare_package(f"{ALIAS}.dec", os.path.join(SRC, "dec"))
_bare_package(f"{ALIAS}.ops", os.path.join(SRC, "ops"))

native = _load("_native")
_build_in_place = native._build


def _build_native():
    """Build the C host tier under a temporary name and rename it into
    place, so that a concurrent process never loads a half-written
    library (`_native._build` writes its output in place)."""
    final = native._SO
    tmp = f"{final}.{os.getpid()}.tmp"
    os.makedirs(os.path.dirname(final), exist_ok=True)
    native._SO = tmp
    try:
        _build_in_place()
    finally:
        native._SO = final
    os.replace(tmp, final)


# the port's own copy of the library, in its build directory
native._SO = os.path.join(BUILD_DIR, "libthorentropy.so")
native._build = _build_native

tables = _load("tables")
bitstream = _load("bitstream")
spec_inter = _load("spec.inter")
spec_filters = _load("spec.filters")
native_parse = _load("dec.native_parse")
decoder = _load("dec.decoder")


def _register_port_modules():
    """Put the port's modules where the host decoder imports them."""
    from .dec import decoder as port_decoder
    from .dec import device_frame, device_pixels
    from .ops import filters, tempinterp
    for name, mod in (("dec.device_pixels", device_pixels),
                      ("dec.device_frame", device_frame),
                      ("ops.filters", filters),
                      ("ops.tempinterp", tempinterp)):
        sys.modules[f"{ALIAS}.{name}"] = mod
    sys.modules[f"{ALIAS}.dec"].decode_stream = port_decoder.decode_stream


_register_port_modules()
