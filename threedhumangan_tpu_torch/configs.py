"""Model configs, shared with the JAX package rather than copied.

``threedhumangan_tpu.configs`` is plain Python: it imports only ``copy`` and
``math``, and ``threedhumangan_tpu/__init__.py`` imports nothing, so reading
it pulls in no JAX.  Callers of the port take the configs from here.
"""

from threedhumangan_tpu.configs import (  # noqa: F401
    MAP3DBN,
    MAP3DBN512,
    MAP3DBN512L,
    MAP3DBN_NANO,
    MAP3DBN_TINY,
    extract_metadata,
)
