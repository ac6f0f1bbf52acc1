"""Native (C) runtime components.

The C sources in this directory are built at first use into
``build/torch_kernels/`` (see kernels/build.py); a failed build raises.
"""
from ..kernels.build import load_c_extension

EcEnc = load_c_extension("ec_native").EcEnc
HAVE_NATIVE_EC = True
