"""Rigid-body (isometry) transform utilities.

The reference library uses Eigen::Isometry3d throughout (e.g.
/root/reference/include/voxelized_geometry_tools/occupancy_map.hpp:121,
/root/reference/src/voxelized_geometry_tools/cpu_pointcloud_voxelization.cpp:171-178).
Here an isometry is a plain ``[4, 4]`` row-major matrix (jnp or np array) so it
is a JAX pytree leaf and transform composition is a matmul that XLA can fuse.

All helpers are dtype-preserving and jit/vmap friendly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


def identity_isometry(dtype=jnp.float32) -> Array:
    return jnp.eye(4, dtype=dtype)


def isometry_from_translation(translation, dtype=jnp.float32) -> Array:
    """Isometry that is a pure translation."""
    t = jnp.asarray(translation, dtype=dtype)
    m = jnp.eye(4, dtype=dtype)
    return m.at[:3, 3].set(t)


def isometry_from_rotation_translation(rotation, translation,
                                       dtype=jnp.float32) -> Array:
    r = jnp.asarray(rotation, dtype=dtype)
    t = jnp.asarray(translation, dtype=dtype)
    m = jnp.eye(4, dtype=dtype)
    m = m.at[:3, :3].set(r)
    return m.at[:3, 3].set(t)


def quaternion_to_rotation_matrix(quaternion) -> Array:
    """Rotation matrix from quaternion ``(w, x, y, z)`` (Eigen order)."""
    q = jnp.asarray(quaternion)
    q = q / jnp.linalg.norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]),
    ])


def isometry_from_quaternion_translation(quaternion, translation,
                                         dtype=jnp.float32) -> Array:
    rot = quaternion_to_rotation_matrix(jnp.asarray(quaternion, dtype=dtype))
    return isometry_from_rotation_translation(rot, translation, dtype=dtype)


def rotation_matrix_to_quaternion(rotation) -> np.ndarray:
    """Quaternion ``(w, x, y, z)`` from a rotation matrix (host-side,
    Shepperd's branch selection for numerical robustness). Inverse of
    :func:`quaternion_to_rotation_matrix`; used to emit the
    translation+quaternion pose of ``geometry_msgs::Pose``
    (``EigenIsometry3dToGeometryPose``, used at ros_interface.hpp:116-121)."""
    m = np.asarray(rotation, np.float64)[:3, :3]
    # Validate at the boundary: a reflection (det < 0), scaled, or NaN
    # matrix would otherwise return a silently wrong (or NaN) quaternion.
    if not np.isfinite(m).all() or not np.allclose(
            m @ m.T, np.eye(3), atol=1e-5) or np.linalg.det(m) < 0.0:
        raise ValueError("not a proper rotation matrix")
    t = np.trace(m)
    if t > 0:
        r = np.sqrt(1.0 + t)
        w = 0.5 * r
        s = 0.5 / r
        q = np.array([w, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                      (m[1, 0] - m[0, 1]) * s])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        s = 0.5 / r
        q = np.zeros(4)
        q[0] = (m[k, j] - m[j, k]) * s
        q[1 + i] = 0.5 * r
        q[1 + j] = (m[j, i] + m[i, j]) * s
        q[1 + k] = (m[k, i] + m[i, k]) * s
    return q / np.linalg.norm(q)


def isometry_to_pose(m) -> tuple:
    """Split a ``[4, 4]`` isometry into ``(translation[3], quaternion_wxyz
    [4])`` — the payload of ``geometry_msgs::Pose``."""
    m = np.asarray(m, np.float64)
    return m[:3, 3].copy(), rotation_matrix_to_quaternion(m)


def isometry_from_axis_angle(axis, angle, dtype=jnp.float32) -> Array:
    """Rotation-only isometry from an axis-angle (Rodrigues)."""
    axis = jnp.asarray(axis, dtype=dtype)
    axis = axis / jnp.linalg.norm(axis)
    a = jnp.asarray(angle, dtype=dtype)
    kx, ky, kz = axis[0], axis[1], axis[2]
    zero = jnp.zeros((), dtype=dtype)
    k = jnp.stack([
        jnp.stack([zero, -kz, ky]),
        jnp.stack([kz, zero, -kx]),
        jnp.stack([-ky, kx, zero]),
    ])
    rot = (jnp.eye(3, dtype=dtype) + jnp.sin(a) * k
           + (1.0 - jnp.cos(a)) * (k @ k))
    return isometry_from_rotation_translation(rot, jnp.zeros(3, dtype=dtype),
                                              dtype=dtype)


def invert_isometry(m: Array) -> Array:
    """Exact inverse of an isometry: ``[R^T, -R^T t]``."""
    r = m[:3, :3]
    t = m[:3, 3]
    rt = r.T
    inv = jnp.eye(4, dtype=m.dtype)
    inv = inv.at[:3, :3].set(rt)
    return inv.at[:3, 3].set(-rt @ t)


def compose(a: Array, b: Array) -> Array:
    return a @ b


def rotate_vector(m: Array, vectors) -> Array:
    """Apply only the rotation part to vector(s) of shape ``[..., 3]``.

    Written elementwise rather than as a matmul: at default precision a
    large float32 ``[..., 3] @ [3, 3]`` contraction may run on the GPU's
    tensor cores as TF32 (about three decimal digits), silently quantizing
    coordinates. Elementwise ops keep full float32 precision and fuse into
    the surrounding code.
    """
    v = jnp.asarray(vectors)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([
        x * m[0, 0] + y * m[0, 1] + z * m[0, 2],
        x * m[1, 0] + y * m[1, 1] + z * m[1, 2],
        x * m[2, 0] + y * m[2, 1] + z * m[2, 2],
    ], axis=-1)


def apply_isometry(m: Array, points) -> Array:
    """Apply an isometry to point(s) of shape ``[..., 3]`` (exact f32; see
    :func:`rotate_vector` for why this avoids a matmul)."""
    return rotate_vector(m, points) + m[:3, 3]


def np_isometry_from_translation(translation, dtype=np.float32) -> np.ndarray:
    m = np.eye(4, dtype=dtype)
    m[:3, 3] = np.asarray(translation, dtype=dtype)
    return m
