"""Optional mitsuba path-traced point-cloud rendering (counterpart of
``gecco_tpu/vis/mitsuba_render.py``): one sphere per point on a floor, a
constant emitter and a look-at camera, with mitsuba 3's ``scalar_rgb``
variant. mitsuba is imported only when a render is made;
``mitsuba_available`` says whether it imports."""

from __future__ import annotations

import numpy as np

__all__ = ["mitsuba_available", "render_cloud_mitsuba"]


def mitsuba_available() -> bool:
    try:
        import mitsuba  # noqa: F401
    except ImportError:
        return False
    return True


def render_cloud_mitsuba(points, resolution: int = 512, point_radius: float = 0.01,
                         spp: int = 64, origin=(1.2, 1.2, 1.2), target=(0.0, 0.0, 0.0),
                         up=(0.0, 0.0, 1.0), color=(0.3, 0.45, 0.7)) -> np.ndarray:
    """Path-trace one cloud [N, 3] to an sRGB uint8 image [H, W, 3]; raises
    ``ImportError`` without mitsuba."""
    import mitsuba as mi

    if mi.variant() is None:
        mi.set_variant("scalar_rgb")
    pts = np.asarray(points, np.float64)
    floor_z = float(pts[:, 2].min()) - 3 * point_radius
    scene = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {
            "type": "perspective",
            "fov": 40.0,
            "to_world": mi.ScalarTransform4f.look_at(origin=list(origin), target=list(target),
                                                     up=list(up)),
            "film": {"type": "hdrfilm", "width": resolution, "height": resolution,
                     "pixel_format": "rgb"},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "emitter": {"type": "constant", "radiance": {"type": "rgb", "value": 0.9}},
        "floor": {
            "type": "rectangle",
            "to_world": mi.ScalarTransform4f.translate([0, 0, floor_z])
            @ mi.ScalarTransform4f.scale(4.0),
            "bsdf": {"type": "diffuse", "reflectance": {"type": "rgb", "value": [0.9] * 3}},
        },
    }
    bsdf = {"type": "diffuse", "reflectance": {"type": "rgb", "value": list(color)}}
    for idx, p in enumerate(pts):
        scene[f"pt_{idx}"] = {"type": "sphere", "center": [float(v) for v in p],
                              "radius": float(point_radius), "bsdf": bsdf}
    image = np.asarray(mi.render(mi.load_dict(scene), spp=spp))
    # linear -> sRGB -> uint8
    srgb = np.where(image <= 0.0031308, 12.92 * image,
                    1.055 * np.clip(image, 0, None) ** (1 / 2.4) - 0.055)
    return (np.clip(srgb, 0.0, 1.0) * 255).astype(np.uint8)
