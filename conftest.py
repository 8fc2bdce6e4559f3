"""Builds the two native host libraries once, before any test runs.

Under pytest-xdist every worker imports every test module, and modules that
ask at import time whether a native library is available make each worker
run that library's `make` at the same moment.  Building both libraries here,
in the controller process and before the workers start, leaves each worker
an up-to-date library, so its own `make` has nothing to do.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):      # a pytest-xdist worker
        return
    from locityper_tpu import native as jax_native
    from locityper_tpu_torch import native

    jax_native.get_lib()
    native.get_lib()
