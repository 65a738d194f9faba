"""Procedural sun/sky emitters (counterpart of mcpt_tpu/scene/sun_sky.py;
csrt src/parser/sun_sky.cpp).

`read_sun_sky` resolves the sun direction (explicit `<vector
name=sunDirection>` or the Julian-date solar ephemeris from
lat/long/time, sun_sky.cpp:160-253) and synthesizes:

  * sun: a lat-long bitmap of the solar disk (Preetham solar radiance
    attenuated by Rayleigh/aerosol/ozone/gas/vapor transmittance,
    sun_sky.cpp:67-152) plus a cone emitter of matching radiance;
  * sky: a lat-long bitmap of the Hosek-Wilkie RGB sky model
    (csrt extern/ArHosekSkyModel) registered as an envmap.

The Hosek model is `scene/hosek.py`, from the published coefficient
tables.  The parser and this module import each other's readers lazily,
inside the functions, so that neither import is a cycle.

Two deliberate departures from csrt, as in the reference: the turbidity
and stretch clamps are correct ([1, 10], [1, 2]), and sunRadiusScale
preserves the sun's power.
"""

from __future__ import annotations

import numpy as np

from mcpt_tpu_torch.scene.ir import EmitterInfo, EmitterType

# Sun geometry constants (csrt sun_sky.hpp:9-16)
EARTH_MEAN_RADIUS = 6371.01    # km
ASTRONOMICAL_UNIT = 149597890  # km
SUN_APP_RADIUS = 0.5358        # degrees


def sun_direction_from_time(year, month, day, hour, minute, second,
                            latitude, longitude, timezone):
    """Solar ephemeris -> unit direction light travels (downward), from
    the PSA algorithm the reference uses (sun_sky.cpp:160-253)."""
    # decimal hours in UT
    dec_hours = hour - timezone + (minute + second / 60.0) / 60.0

    # elapsed Julian days since 1 Jan 2000 12h UT
    li_aux1 = (month - 14) // 12
    li_aux2 = (1461 * (year + 4800 + li_aux1)) // 4 + (
        367 * (month - 2 - 12 * li_aux1)
    ) // 12 - (3 * ((year + 4900 + li_aux1) // 100)) // 4 + day - 32075
    elapsed = -0.5 + dec_hours / 24.0 + li_aux2 - 2451545.0

    omega = 2.1429 - 0.0010394594 * elapsed
    mean_long = 4.8950630 + 0.017202791698 * elapsed
    anomaly = 6.2400600 + 0.0172019699 * elapsed
    ecl_long = (
        mean_long
        + 0.03341607 * np.sin(anomaly)
        + 0.00034894 * np.sin(2 * anomaly)
        - 0.0001134
        - 0.0000203 * np.sin(omega)
    )
    obliquity = 0.4090928 - 6.2140e-9 * elapsed + 0.0000396 * np.cos(omega)

    sin_ecl = np.sin(ecl_long)
    y = np.cos(obliquity) * sin_ecl
    x = np.cos(ecl_long)
    right_asc = np.arctan2(y, x)
    if right_asc < 0:
        right_asc += 2 * np.pi
    decl = np.arcsin(np.sin(obliquity) * sin_ecl)

    gmst = 6.6974243242 + 0.0657098283 * elapsed + dec_hours
    lmst = np.radians(gmst * 15 + longitude)
    hour_angle = lmst - right_asc
    lat_r = np.radians(latitude)

    cos_lat, sin_lat = np.cos(lat_r), np.sin(lat_r)
    zenith = np.arccos(
        np.clip(
            cos_lat * np.cos(hour_angle) * np.cos(decl)
            + np.sin(decl) * sin_lat,
            -1.0,
            1.0,
        )
    )
    dy = -np.sin(hour_angle)
    dx = np.tan(decl) * cos_lat - sin_lat * np.cos(hour_angle)
    azimuth = np.arctan2(dy, dx)
    if azimuth < 0:
        azimuth += 2 * np.pi
    # parallax correction
    zenith += (EARTH_MEAN_RADIUS / ASTRONOMICAL_UNIT) * np.sin(zenith)

    # direction the light travels: from the sun toward the scene.
    # world frame: y up, matching the reference's lat-long convention
    sin_z = np.sin(zenith)
    to_sun = np.array(
        [sin_z * np.cos(azimuth), np.cos(zenith), sin_z * np.sin(azimuth)],
        np.float32,
    )
    return -to_sun


def read_sun_direction(ctx, node):
    from mcpt_tpu_torch.scene.parser import _child_by_name, _read_float, _read_vec3_node

    vec_node = _child_by_name(node, ("sunDirection", "sun_direction"))
    if vec_node is not None:
        d = _read_vec3_node(vec_node, [0.0, -1.0, 0.0])
        # Mitsuba's sunDirection points TOWARD the sun
        d = np.asarray(d, np.float32)
        return -d / max(np.linalg.norm(d), 1e-12)
    year = int(_read_float(ctx, node, ("year",), 2010))
    month = int(_read_float(ctx, node, ("month",), 7))
    day = int(_read_float(ctx, node, ("day",), 10))
    hour = _read_float(ctx, node, ("hour",), 15.0)
    minute = _read_float(ctx, node, ("minute",), 0.0)
    second = _read_float(ctx, node, ("second",), 0.0)
    lat = _read_float(ctx, node, ("latitude",), 35.6894)
    lon = _read_float(ctx, node, ("longitude",), 139.6917)
    tz = _read_float(ctx, node, ("timezone",), 9.0)
    return sun_direction_from_time(
        year, month, day, hour, minute, second, lat, lon, tz
    )


def read_sun_sky(ctx, node, etype: str):
    """Parse `<emitter type=sun|sky|sunsky>` (parser.cpp:1279-1394).

    NOTE: the reference's turbidity/stretch clamps are inverted
    (fmin(fmax(t, 10), 1) == always 1, parser.cpp:1322-1323,1367-1368);
    we clamp correctly to [1, 10] / [1, 2]."""
    from mcpt_tpu_torch.scene.parser import _read_bool, _read_float, _read_int, _read_vec3

    direction = read_sun_direction(ctx, node)
    turbidity = float(
        np.clip(_read_float(ctx, node, ("turbidity",), 3.0), 1.0, 10.0)
    )
    resolution = _read_int(ctx, node, ("resolution",), 512)
    width, height = resolution, resolution // 2

    if etype in ("sun", "sunsky"):
        from mcpt_tpu_torch.scene import spectrum

        scale = _read_float(ctx, node, ("sunScale", "sun_scale"), 1.0)
        radius_scale = _read_float(
            ctx, node, ("sunRadiusScale", "sun_radius_scale"), 1.0
        )
        true_radius = np.radians(SUN_APP_RADIUS * 0.5)
        app_radius = true_radius * radius_scale
        zenith = float(np.arccos(np.clip(-direction[1], -1.0, 1.0)))
        disk_radiance = spectrum.sun_radiance_rgb(zenith, turbidity) * scale
        # sunRadiusScale enlarges the VISIBLE disk but preserves total
        # power (Mitsuba semantics; the reference does the same: NEE
        # total = radiance x UNSCALED solid angle, sun_sky.cpp:260-265,
        # and the splat spreads that total over the scaled disk,
        # :268-299).  Without the 1/scale^2 the classroom sun
        # (sunRadiusScale 18.8) injects ~354x too much energy.
        solid_angle = 2.0 * np.pi * (1.0 - np.cos(true_radius))
        solid_angle_vis = 2.0 * np.pi * (1.0 - np.cos(app_radius))
        bitmap = splat_sun_bitmap(
            direction,
            app_radius,
            disk_radiance * (solid_angle / solid_angle_vis),
            width,
            height,
        )
        tid = ctx.tex.add_bitmap(bitmap)
        ctx.config.emitters.append(
            EmitterInfo(
                etype=EmitterType.SUN,
                direction=direction,
                radiance=disk_radiance * solid_angle,
                cutoff_angle=np.degrees(app_radius),
                id_texture=tid,
            )
        )

    if etype in ("sky", "sunsky"):
        from mcpt_tpu_torch.scene import hosek

        albedo = _read_vec3(ctx, node, ("albedo",), [0.15] * 3)
        stretch = float(
            np.clip(_read_float(ctx, node, ("stretch",), 1.0), 1.0, 2.0)
        )
        scale = _read_float(ctx, node, ("skyScale", "sky_scale"), 1.0)
        extend = _read_bool(ctx, node, ("extend",), True)
        bitmap = hosek.sky_bitmap(
            direction,
            turbidity,
            albedo,
            width,
            height,
            stretch=stretch,
            extend=extend,
            radiance_scale=scale,
        )
        tid = ctx.tex.add_bitmap(bitmap)
        ctx.config.emitters.append(
            EmitterInfo(
                etype=EmitterType.ENVMAP,
                id_texture=tid,
                to_world=np.eye(4, dtype=np.float32),
            )
        )


def splat_sun_bitmap(direction, app_radius, radiance, width=512, height=256):
    """Lat-long bitmap containing the solar disk (sun_sky.cpp:255-303)."""
    to_sun = -np.asarray(direction, np.float64)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    theta = v * np.pi
    phi = u * 2 * np.pi
    dirs = np.stack(
        [
            np.sin(theta)[:, None] * np.cos(phi)[None, :],
            np.cos(theta)[:, None] * np.ones_like(phi)[None, :],
            np.sin(theta)[:, None] * np.sin(phi)[None, :],
        ],
        axis=-1,
    )
    cos_angle = dirs @ to_sun
    inside = cos_angle >= np.cos(app_radius)
    img = np.zeros((height, width, 3), np.float32)
    img[inside] = radiance
    return img
