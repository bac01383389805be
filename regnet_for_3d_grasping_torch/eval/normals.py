"""Point-cloud normals (JAX ``eval/normals.py``): PCA normals oriented
toward the camera, on the device of `points`.

``method="knn"`` is open3d's hybrid search (at most `max_nn` nearest within
`radius`); ``method="moment"`` takes every point within `radius`, through
one masked-moment product per chunk of queries (the evaluator's choice).
The smallest eigenvector of each 3x3 covariance is the closed form of
`smallest_eigvec_3x3`.

The covariances are summed in f64 and rounded to f32 before the f32
eigenvector.  JAX sums them in f32, where E[pp^T] - mu mu^T cancels three
to four digits; so JAX's own normals carry that rounding, and the port's
are its f32 rounding of the exact ones.  In f64 the card's and the CPU's
sums round to the same f32 covariance, whatever their order.
"""

from __future__ import annotations

import math

import torch

from regnet_for_3d_grasping_torch.ops.distances import bpdist2


def _det3(B: torch.Tensor) -> torch.Tensor:
    """Cofactor determinant of [..., 3, 3] (JAX takes an LU; the two differ
    in the last bits)."""
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))


def smallest_eigvec_3x3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric
    [..., 3, 3] (JAX ``normals.py:37``): the trigonometric eigenvalue, then
    the longest of the three cross products of rows of A - lambda I (the
    first where two are as long); (0, 0, 1) where all vanish."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = (B * B).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(_det3(B) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    C = A - lam_min[..., None, None] * eye
    r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], -2)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    # first index of the largest, as jnp.argmax
    best = torch.argmax(norms, dim=-1)
    vec = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    n = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype,
                            device=A.device).expand(vec.shape)
    return torch.where(n > 1e-12, vec / torch.clamp(n, min=1e-12), fallback)


def _nearest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the `k` smallest of each row of `d2` (f32, >= 0),
    ascending, equal distances in index order (`lax.top_k`'s order): one
    top-k over (distance bits, index) packed into an int64."""
    d2 = d2 + 0.0                      # -0.0 sorts with 0.0
    key = (d2.view(torch.int32).long() << 32) | torch.arange(
        d2.shape[-1], device=d2.device)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values \
        & 0xFFFFFFFF


def estimate_normals(points: torch.Tensor, camera_pos: torch.Tensor,
                     radius: float = 0.01, max_nn: int = 30,
                     chunk: int = 4096, method: str = "knn",
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 3] points -> [N, 3] unit normals oriented toward `camera_pos`
    (JAX ``normals.py:69``); with `rows` (int64 [R]), the normals of those
    points alone, [R, 3].  `chunk` queries at a time; the chunk and `rows`
    change a normal only through the order of the moment path's f64 sums
    (the product's blocking follows the chunk's rows)."""
    if method not in ("knn", "moment"):
        raise ValueError(f"unknown normals method {method!r}")
    points = points.float()
    camera_pos = torch.as_tensor(camera_pos, dtype=torch.float32,
                                 device=points.device)
    N = points.shape[0]
    r2 = torch.tensor(radius * radius, dtype=torch.float32,
                      device=points.device)
    # centred, so that E[pp^T] - mu mu^T cancels on O(r) magnitudes; the
    # covariances are taken in f64 and rounded to f32 (see the module note)
    pts_c = points.double() - points.double().mean(0)
    x, y, z = pts_c.unbind(-1)
    mom = torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z], 1)

    def moment(d2):
        w = (d2 <= r2).double()
        cnt = torch.clamp(w.sum(1), min=1.0)
        s = torch.matmul(w, mom) / cnt[:, None]
        m1, m2 = s[:, :3], s[:, 3:]
        xx, yy, zz, xy, xz, yz = m2.unbind(-1)
        cov = torch.stack([torch.stack([xx, xy, xz], -1),
                           torch.stack([xy, yy, yz], -1),
                           torch.stack([xz, yz, zz], -1)], -2)
        return (cov - m1[:, :, None] * m1[:, None, :]).float()

    def knn(d2):
        idx = _nearest(d2, min(max_nn, N))
        valid = torch.gather(d2, 1, idx) <= r2
        neigh = points.double()[idx]                      # [chunk, K, 3]
        w = valid.double()[..., None]
        cnt = torch.clamp(w.sum(1), min=1.0)
        mean = (neigh * w).sum(1) / cnt
        diff = (neigh - mean[:, None, :]) * w
        return ((diff[..., :, None] * diff[..., None, :]).sum(1)
                / cnt[..., None]).float()

    cov_of = moment if method == "moment" else knn
    queries = points if rows is None else points[rows]
    normals = torch.cat([
        smallest_eigvec_3x3(cov_of(bpdist2(queries[None, q:q + chunk],
                                           points[None])[0]))
        for q in range(0, len(queries), chunk)])
    to_cam = camera_pos[None, :] - queries
    sign = torch.sign((normals * to_cam).sum(-1, keepdim=True))
    return normals * torch.where(sign == 0, 1.0, sign)
