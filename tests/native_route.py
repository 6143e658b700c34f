"""Pin which native-library route the JAX package and the PyTorch port take
in one test.

Both packages reach ``native/mmio.cpp`` through their ``io.native``
modules, each with its own loader, and fall back to Python where their
loader finds no library.  Two loaders in one process can disagree (one
built the library, the other did not), and then the same call takes two
routes, which may print or round differently.  A parity test therefore
pins one route for both packages: the port's loaded library for both
(the JAX module sets its argtypes on that same object), or ``None`` for
both.  Import the fixtures into a test module to use them.
"""

import pytest

import multimodars_torch.io.native as t_native
import multimodars_tpu.io.native as j_native


def pin_route(monkeypatch, route):
    """Give both packages the port's library (``"native"``) or none
    (``"python"``); skip a native case when the library cannot be built."""
    if route == "native":
        lib = t_native.get_library()
        if lib is None:
            pytest.skip("the port's native library cannot be built here (no g++)")
        get = lambda: lib  # noqa: E731
    else:
        get = lambda: None  # noqa: E731
    monkeypatch.setattr(t_native, "get_library", get)
    monkeypatch.setattr(j_native, "get_library", get)
    return route


@pytest.fixture(params=["native", "python"])
def native_route(request, monkeypatch):
    """Each case once on the native route and once on the Python route."""
    return pin_route(monkeypatch, request.param)


@pytest.fixture
def one_native_route(monkeypatch):
    """One route for both packages, never a skip: the native library where
    it builds, else the Python route."""
    route = "native" if t_native.get_library() is not None else "python"
    return pin_route(monkeypatch, route)
