"""The port's plots (``tpusysbio_torch/viz.py``) against the JAX package's
``viz`` under Agg, on ``tests/test_io_viz.py``'s fitted MM-3 project and
profile.

Equal panel counts, titles and labels, and every plotted line's data
within 1e-8 of the reference's (the model curves come from each package's
own integration at rtol 1e-7; the data and error bars are the same
numbers).
"""

import dataclasses

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import test_io_viz as ref  # noqa: E402
from tpusysbio import viz as jviz  # noqa: E402
from tpusysbio.config import FitConfig as JFitConfig  # noqa: E402
from tpusysbio.fit import profile_likelihood as jprofile  # noqa: E402
from tpusysbio_torch import FitConfig, SolverConfig, convert, viz  # noqa: E402
from tpusysbio_torch.fit import profile_likelihood  # noqa: E402
from tpusysbio_torch.model import library  # noqa: E402
from tpusysbio_torch.project import Project  # noqa: E402

torch.set_num_threads(1)


def _lines(fig):
    """Every line's (x, y) data of every axes, in drawing order."""
    return [[(np.asarray(ln.get_xdata(), float),
              np.asarray(ln.get_ydata(), float)) for ln in ax.lines]
            for ax in fig.axes]


def _same_lines(fig, jfig, tol=1e-8):
    got, want = _lines(fig), _lines(jfig)
    assert [len(a) for a in got] == [len(a) for a in want]
    for ax_got, ax_want in zip(got, want):
        for (x, y), (xj, yj) in zip(ax_got, ax_want):
            np.testing.assert_allclose(x, xj, rtol=0, atol=tol)
            np.testing.assert_allclose(y, yj, rtol=tol, atol=tol)


def _fields(obj):
    return {f.name: (np.asarray(v) if isinstance(v, jax.Array) else v)
            for f in dataclasses.fields(obj)
            for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def projects():
    """The reference's fitted MM-3 project and the port's on the same
    batch and map."""
    jproj, jtheta = ref._fitted_project()
    proj = Project(model=library.michaelis_menten(device="cpu"),
                   pmap=convert.pmap_from_reference(_fields(jproj.pmap),
                                                    device="cpu"),
                   batch=convert.batch_from_reference(_fields(jproj.batch),
                                                      device="cpu"),
                   config=SolverConfig(rtol=1e-7, atol=1e-9))
    return proj, jproj, np.asarray(jtheta)


def test_plot_fit_matches_reference(projects):
    proj, jproj, theta = projects
    fig = viz.plot_fit(proj, torch.as_tensor(theta), n_dense=40)
    jfig = jviz.plot_fit(jproj, jnp.asarray(theta), n_dense=40)
    assert len(fig.axes) == len(jfig.axes) == 1
    ax, jax_ = fig.axes[0], jfig.axes[0]
    assert len(ax.containers) == len(jax_.containers) == 2
    assert ax.get_title() == jax_.get_title()
    _same_lines(fig, jfig)
    plt.close(fig)
    plt.close(jfig)


def test_plot_waterfall_matches_reference():
    class Result:
        cost = torch.as_tensor([3.0, 1.0, np.inf, 2.0, 1.5])
        status = torch.as_tensor([1, 2, 1, -1, 0])

    jres = type("J", (), {"cost": np.asarray(Result.cost),
                          "status": np.asarray(Result.status)})
    for top in (None, 2):
        fig = viz.plot_waterfall(Result, top=top)
        jfig = jviz.plot_waterfall(jres, top=top)
        assert fig.axes[0].get_ylabel() == "final cost"
        assert ([t.get_text() for t in fig.axes[0].get_legend().texts]
                == [t.get_text() for t in jfig.axes[0].get_legend().texts])
        _same_lines(fig, jfig, tol=0)
        plt.close(fig)
        plt.close(jfig)


def test_plot_profiles_matches_reference():
    target = np.asarray([1.0, -2.0])
    sigma = np.asarray([0.5, 2.0])

    def r_fn(th):
        return (th - torch.as_tensor(target)) / torch.as_tensor(sigma)

    def rj_fn(th):
        J = torch.diag(1.0 / torch.as_tensor(sigma))
        return r_fn(th), J.expand(th.shape[0], 2, 2)

    prof = profile_likelihood(r_fn, rj_fn, torch.as_tensor(target),
                              n_points=3, span=5.0,
                              config=FitConfig(max_iter=20))
    jprof = jprofile(lambda th: (th - target) / sigma,
                     lambda th: ((th - target) / sigma,
                                 jnp.diag(1.0 / sigma)),
                     jnp.asarray(target), n_points=3, span=5.0,
                     config=JFitConfig(max_iter=20))
    fig = viz.plot_profiles(prof, names=["k1", "k2"])
    jfig = jviz.plot_profiles(jprof, names=["k1", "k2"])
    assert len([a for a in fig.axes if a.axison]) == 2
    assert [a.get_title() for a in fig.axes] == [a.get_title()
                                                for a in jfig.axes]
    _same_lines(fig, jfig)
    plt.close(fig)
    plt.close(jfig)


@pytest.fixture
def no_matplotlib(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_mpl(name, *args, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)


@pytest.mark.parametrize("entry", ["viz.plot_waterfall", "cli multistart",
                                   "cli profile"])
def test_missing_matplotlib_raises_naming_it(no_matplotlib, entry):
    """Without matplotlib the port raises ``ImportError`` naming it, and
    the CLI does so before it fits anything; it never skips the plot."""
    from tpusysbio_torch import cli

    calls = {
        "viz.plot_waterfall": lambda: viz.plot_waterfall(
            type("R", (), {"cost": np.ones(2), "status": np.ones(2)})),
        "cli multistart": lambda: cli.main(
            ["--cpu", "multistart", "--model", "mm3", "--plot", "x"]),
        "cli profile": lambda: cli.main(["--cpu", "profile", "--plot", "x"]),
    }
    with pytest.raises(ImportError, match="matplotlib"):
        calls[entry]()
