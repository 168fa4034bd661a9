from gsorb_slam_tpu_torch.raster.types import RasterConfig, RenderOutput
from gsorb_slam_tpu_torch.raster.preprocess import Preprocessed, preprocess
from gsorb_slam_tpu_torch.raster.naive import render_naive
from gsorb_slam_tpu_torch.raster.binning import TileBins, bin_gaussians
from gsorb_slam_tpu_torch.raster.tiled import render, render_binned, render_tiled

__all__ = [
    "RasterConfig",
    "RenderOutput",
    "Preprocessed",
    "preprocess",
    "render_naive",
    "TileBins",
    "bin_gaussians",
    "render_binned",
    "render_tiled",
    "render",
]
