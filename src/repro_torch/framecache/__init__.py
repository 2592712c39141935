"""Cross-frame reuse subsystem: pose-delta warping of probe maps and
cached radiance (``repro.framecache``).

Three reuse tiers:
  1. intra-frame dedup — core/reuse.py (the locality profiles);
  2. warped Phase-I probe maps — probe.py (counts/opacity/depth transfer
     between nearby poses, reprojected by the pose delta);
  3. warped Phase-II radiance — radiance.py (finished frames warp to new
     poses; only disoccluded rays re-march).
warp.py holds the shared depth-guided reprojection primitive; the
scene-space block tier (scenecache/) plugs into render.py.
"""
from .probe import (ProbeCache, ProbeMaps, ProbePlan,  # noqa: F401
                    ProbeReuseConfig, cached_probe_maps,
                    commit_probe_plan, execute_probe_plan, plan_probe,
                    probe_phase_cached)
from .radiance import (RadianceCache, RadiancePlan,  # noqa: F401
                       RadianceReuseConfig, WarpedRadiance,
                       commit_lookup, plan_lookup)
from .render import (FrameCache, make_frame_cache,  # noqa: F401
                     render_asdr_image_cached)
from . import warp  # noqa: F401
