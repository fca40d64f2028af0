"""The port's analytic model (repro_torch.core.analytic) against the
reference's (repro.core.analytic): the same arrays, exactly."""
import numpy as np
import pytest

from repro.core import analytic as RA
from repro_torch.core import analytic as TA

KS = np.array([1, 2, 4, 8, 16, 32, 64, 128, 256])


@pytest.mark.parametrize("c_s,c_b,task_len", [(8.0, 8.0, 16_000.0),
                                              (1.0, 2.0, 4_000.0),
                                              (64.0, 32.0, 16_000.0)])
@pytest.mark.parametrize("m,n", [(256, 256), (256, 100), (64, 50)])
def test_omegas_and_speedup_equal_reference(m, n, c_s, c_b, task_len):
    ks = KS[KS <= m]
    rp = RA.TimingParams(c_b=c_b, c_s=c_s, task_len=task_len)
    tp = TA.TimingParams(c_b=c_b, c_s=c_s, task_len=task_len)
    for name, args in (("omega_s", (ks, c_s)),
                       ("omega_cmp", (m, n, ks, c_s)),
                       ("omega_msg", (m, n, ks, c_b))):
        assert np.array_equal(getattr(TA, name)(*args),
                              getattr(RA, name)(*args)), name
    assert np.array_equal(TA.omega(m, n, ks, tp), RA.omega(m, n, ks, rp))
    assert np.array_equal(TA.speedup(m, n, ks, tp), RA.speedup(m, n, ks, rp))
    assert np.array_equal(TA.speedup(m, n, ks, tp, l=1234.5),
                          RA.speedup(m, n, ks, rp, l=1234.5))
    assert TA.optimal_k(m, n, tp) == RA.optimal_k(m, n, rp)


@pytest.mark.parametrize("kw", [{}, dict(m=64, n=100, c_s_values=(2.0,)),
                                dict(m=1024, n=512,
                                     c_s_values=(1.0, 8.0, 64.0, 256.0))])
def test_fig2a_equals_reference(kw):
    assert TA.fig2a(**kw) == RA.fig2a(**kw)
