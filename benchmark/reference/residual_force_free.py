"""The force-free residual (Compere et al., arXiv:1606.06727).

With A = u_rr + u_zz - u_r / rho, B = u_r**2 + u_z**2 and
T = u_z d/drho - u_r d/dz, the residual is L_T A * L_T^2 B - L_T B * L_T^2 A.
"""

from __future__ import annotations

from .residuals import Term

ORDER = 4


def residual(d, de, points):
    t = {k: Term(v, None, de[k]) for k, v in d.items()}
    r = points[..., 0]
    ir, ir2, ir3 = 1.0 / r, 1.0 / (r * r), 1.0 / (r * r * r)
    u_r, u_z = t[(1, 0)], t[(0, 1)]
    u_rr, u_rz, u_zz = t[(2, 0)], t[(1, 1)], t[(0, 2)]
    u_rrr, u_rrz, u_rzz, u_zzz = t[(3, 0)], t[(2, 1)], t[(1, 2)], t[(0, 3)]
    u_rrrr, u_rrrz = t[(4, 0)], t[(3, 1)]
    u_rrzz, u_rzzz, u_zzzz = t[(2, 2)], t[(1, 3)], t[(0, 4)]

    # A = u_rr + u_zz - u_r / rho and its derivatives to the second order
    A_r = u_rrr + u_rzz - u_rr * ir + u_r * ir2
    A_z = u_rrz + u_zzz - u_rz * ir
    A_rr = u_rrrr + u_rrzz - u_rrr * ir + 2.0 * u_rr * ir2 - 2.0 * u_r * ir3
    A_rz = u_rrrz + u_rzzz - u_rrz * ir + u_rz * ir2
    A_zz = u_rrzz + u_zzzz - u_rzz * ir
    # B = u_r**2 + u_z**2
    B_r = 2.0 * u_r * u_rr + 2.0 * u_z * u_rz
    B_z = 2.0 * u_r * u_rz + 2.0 * u_z * u_zz
    B_rr = (2.0 * u_rr * u_rr + 2.0 * u_r * u_rrr + 2.0 * u_rz * u_rz
            + 2.0 * u_z * u_rrz)
    B_rz = (2.0 * u_rz * u_rr + 2.0 * u_r * u_rrz + 2.0 * u_zz * u_rz
            + 2.0 * u_z * u_rzz)
    B_zz = (2.0 * u_rz * u_rz + 2.0 * u_r * u_rzz + 2.0 * u_zz * u_zz
            + 2.0 * u_z * u_zzz)

    def lie(f_r, f_z):
        # L_T f = u_z f_r - u_r f_z
        return u_z * f_r - u_r * f_z

    def lie2(f_r, f_z, f_rr, f_rz, f_zz):
        # L_T (L_T f): differentiate u_z f_r - u_r f_z once more
        g_r = u_rz * f_r + u_z * f_rr - u_rr * f_z - u_r * f_rz
        g_z = u_zz * f_r + u_z * f_rz - u_rz * f_z - u_r * f_zz
        return lie(g_r, g_z)

    LA = lie(A_r, A_z)
    LB = lie(B_r, B_z)
    L2A = lie2(A_r, A_z, A_rr, A_rz, A_zz)
    L2B = lie2(B_r, B_z, B_rr, B_rz, B_zz)
    res = LA * L2B - LB * L2A
    return res.v, res.m, res.e
