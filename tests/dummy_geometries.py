"""The reference's synthetic test geometries (src/intravascular/utils/
test_utils.rs:111-384), built from either package's model classes: the
recipe of tests/conftest.py's ``dummy_geometry`` and
``dummy_geometry_aligned_long`` with the package passed in, so that the
port's parity tests can build the same objects for ``multimodars_torch``
and ``multimodars_tpu``."""

import math

SQUAREISH = [(1.0, 3.0), (0.0, 2.0), (0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (2.0, 2.0)]


def make_contour(pkg, id_, xy, z, original_frame=None, kind="Lumen"):
    points = [pkg.PyContourPoint(id_, i, x, y, z, False) for i, (x, y) in enumerate(xy)]
    c = pkg.PyContour(
        id_, original_frame if original_frame is not None else id_, points,
        (0.0, 0.0, z), None, None, kind,
    )
    c.compute_centroid()
    return c


def dummy_geometry(pkg):
    """Three square-ish frames with baked-in rotations of 0/15/30 deg and
    translations (0,0)/(1,1)/(2,2) (test_utils.rs:111-336)."""
    contours = []
    for fid, (orig, dz, rot_deg, t) in enumerate(
        [(1, 0.0, 0.0, (0.0, 0.0)), (2, 1.0, 15.0, (1.0, 1.0)), (3, 2.0, 30.0, (2.0, 2.0))]
    ):
        c = make_contour(pkg, fid, SQUAREISH, dz, original_frame=orig)
        c = c.translate(t[0], t[1], 0.0)
        c.compute_centroid()
        cx, cy, _ = c.centroid
        c.rotate_rad_inplace(math.radians(rot_deg), (cx, cy))
        contours.append(c)

    frames = []
    for i, c in enumerate(contours):
        ref = pkg.PyContourPoint(1, 0, 3.0, 1.0, 0.0, False) if i == 0 else None
        frames.append(pkg.PyFrame(c.id, c.centroid, c, {}, ref))
    return pkg.PyGeometry(frames, "dummy_geometry")


def dummy_geometry_aligned_long(pkg):
    """Six aligned frames at z = 0..5 (test_utils.rs:338-384)."""
    g1 = dummy_geometry(pkg)
    g1.frames[1].translate_inplace(-1.0, -1.0, 0.0)
    g1.frames[2].translate_inplace(-2.0, -2.0, 0.0)
    c1 = g1.frames[1].centroid
    g1.frames[1].rotate_inplace(math.radians(-15.0), (c1[0], c1[1]))
    c2 = g1.frames[2].centroid
    g1.frames[2].rotate_inplace(math.radians(-30.0), (c2[0], c2[1]))

    g2 = g1.copy()
    for i, frame in enumerate(g2.frames):
        idx = i + 3
        frame.translate_inplace(0.0, 0.0, 4.0)
        frame.set_value(idx, None, frame.lumen.centroid, float(idx))

    frames = g1.frames + g2.frames
    frames[3].reference_point = None
    return pkg.PyGeometry(frames, "dummy_geometry_center_reference")
