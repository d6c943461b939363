"""BDF ingestion tests (reference crm.py:62-121 capability, on device).

A cantilever plate strip is written as NASTRAN bulk data (mixed small-field
and free-field cards), parsed, run end-to-end through CRM.from_bdf on both
factor paths, and the adjoint gradient is FD-checked.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from eigd_tpu.fem.bdf import bfs_levels, parse_bdf


def plate_bdf_lines(nx=4, ny=12, Lx=1.0, Ly=3.0, t=0.01):
    """Cantilever plate: (nx+1)*(ny+1) grid in the x-y plane, clamped at
    y=0, two PSHELL components (lower/upper half in y)."""
    lines = ["$ generated cantilever plate", "BEGIN BULK"]

    def nid(i, j):
        return 1 + i + j * (nx + 1)

    for j in range(ny + 1):
        for i in range(nx + 1):
            x = Lx * i / nx
            y = Ly * j / ny
            # small-field GRID: fields of 8 chars
            lines.append(f"GRID    {nid(i, j):<8d}        "
                         f"{x:<8.4f}{y:<8.4f}{0.0:<8.4f}")
    eid = 1
    for j in range(ny):
        pid = 1 if j < ny // 2 else 2
        for i in range(nx):
            lines.append(
                f"CQUAD4,{eid},{pid},{nid(i, j)},{nid(i + 1, j)},"
                f"{nid(i + 1, j + 1)},{nid(i, j + 1)}")
            eid += 1
    # implicit-exponent number format on purpose: 1.0-2 == 1.0e-2
    lines.append(f"PSHELL,1,7,{t}")
    lines.append("PSHELL,2,7,1.0-2")
    lines.append("MAT1,7,7.0+10,,0.3,2700.0")
    clamped = ",".join(str(nid(i, 0)) for i in range(nx + 1))
    lines.append(f"SPC1,5,123456,{clamped}")
    lines.append("ENDDATA")
    return lines


class TestParser:
    def test_parse_plate(self):
        mdl = parse_bdf(plate_bdf_lines())
        assert mdl.X.shape == (5 * 13, 3)
        assert mdl.conn.shape == (4 * 12, 4)
        assert len(mdl.component_names) == 2
        np.testing.assert_allclose(mdl.thickness, [0.01, 0.01])
        assert mdl.E == pytest.approx(7.0e10)
        assert mdl.nu == pytest.approx(0.3)
        assert mdl.rho == pytest.approx(2700.0)
        assert mdl.spc_nodes.size == 5

    def test_nastran_float(self):
        from eigd_tpu.fem.bdf import _nastran_float

        assert _nastran_float("1.2-3") == pytest.approx(1.2e-3)
        assert _nastran_float("-4.5+2") == pytest.approx(-450.0)
        assert _nastran_float("1.5e-3") == pytest.approx(1.5e-3)

    def test_large_field_named_continuation(self):
        # GRID* with a NAMED continuation marker ('*AB1'): both lines must
        # be split as 16-char large-field columns or the 16-char numerics
        # are truncated (ADVICE r3). z lives on the continuation line.
        lines = [
            "BEGIN BULK",
            "GRID*   1                               "
            "987.6543210987  1.23456789-3    *AB1",
            "*AB1    2.5",
            "GRID*   2                               "
            "0.0             0.0             *AB2",
            "*AB2    0.0",
            "CQUAD4,1,1,1,2,3,4",
            "GRID,3,,1.0,1.0,0.0",
            "GRID,4,,0.0,1.0,0.0",
            "PSHELL,1,7,0.01",
            "MAT1,7,7.0+10,,0.3,2700.0",
            "ENDDATA",
        ]
        mdl = parse_bdf(lines)
        i1 = int(np.searchsorted(mdl.node_ids, 1))
        np.testing.assert_allclose(
            mdl.X[i1], [987.6543210987, 1.23456789e-3, 2.5], rtol=1e-12)

    def test_unreferenced_grids_dropped(self):
        lines = plate_bdf_lines()
        # an orphan grid (no CQUAD4 references it) must not create
        # zero-stiffness DOFs
        lines.insert(-1, "GRID,9999,,5.0,5.0,5.0")
        mdl = parse_bdf(lines)
        assert 9999 not in mdl.node_ids
        assert mdl.X.shape == (5 * 13, 3)
        assert any("unreferenced" in w or "dropped" in w
                   for w in mdl.warnings)

    def test_partial_spc_component_warning(self):
        lines = plate_bdf_lines()
        # constrain one interior node in component 3 only: the full-clamp
        # promotion must be recorded
        lines.insert(-1, "SPC,5,17,3,0.0")
        mdl = parse_bdf(lines)
        assert any("promoted" in w for w in mdl.warnings)
        # the fully-clamped SPC1 deck alone stays warning-free
        assert not any("promoted" in w
                       for w in parse_bdf(plate_bdf_lines()).warnings)

    def test_bfs_levels_block_tridiagonal(self):
        mdl = parse_bdf(plate_bdf_lines())
        levels, nlev = bfs_levels(mdl.conn, mdl.X.shape[0], mdl.spc_nodes)
        assert np.all(levels[mdl.spc_nodes] == 0)
        lv = levels[mdl.conn]
        assert int((lv.max(axis=1) - lv.min(axis=1)).max()) <= 1


class TestEndToEnd:
    def test_from_bdf_modal_and_gradient(self, tmp_path):
        from eigd_tpu.models.crm import CRM

        path = tmp_path / "plate.bdf"
        path.write_text("\n".join(plate_bdf_lines()) + "\n")

        m = CRM.from_bdf(str(path), N=3, m=40, factor_kind="cholesky")
        assert m.ncomp == 2
        m.initialize()
        lam = np.asarray(m.lam)
        assert np.all(lam > 0) and np.all(np.diff(lam) > -1e-12)

        # scalable (BFS-level block-tridiag) path matches the dense oracle
        m2 = CRM.from_bdf(str(path), N=3, m=40, factor_kind="bcr_f32")
        m2.initialize()
        np.testing.assert_allclose(np.asarray(m2.lam), lam, rtol=1e-7)

        # adjoint gradient of the modal compliance vs FD
        m.initialize_adjoint()
        m.add_modal_compliance_derivative(1.0)
        m.finalize_adjoint()
        x0 = jnp.asarray(m.x)
        pert = jnp.asarray(np.random.default_rng(2).uniform(size=x0.shape))
        # h-sweep measured: rel 1.4e-7 at hrel 1e-3, 3.8e-7 at 1e-4, then
        # 1/h solver-noise growth — 1e-4 sits on the flat part
        h = 1e-4 * float(x0[0])

        def val(x):
            m.x = x
            m.initialize()
            return float(m.get_modal_compliance())

        fd = (val(x0 + h * pert) - val(x0 - h * pert)) / (2 * h)
        m.x = x0
        rel = abs(float(pert @ m.xb) - fd) / abs(fd)
        assert rel < 1e-6, rel
