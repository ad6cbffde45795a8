"""LS-Gaussian renderer "architecture" — the paper's own workload as an
extra dry-run config: gaussian-parallel preprocess + tile-parallel raster
(the port's copy of the reference's ``configs/lsgaussian.py``, field for
field). ``get_config("lsgaussian")`` returns it; the dry-run's CLI does
not offer it, and ``launch/dryrun.run_cell`` on it reports an error, as
the reference's does.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RendererArch:
    name: str = "lsgaussian"
    family: str = "renderer"
    num_gaussians: int = 2_000_000
    image_width: int = 1920
    image_height: int = 1088
    tile_capacity: int = 1024
    sh_degree: int = 3


CONFIG = RendererArch()
