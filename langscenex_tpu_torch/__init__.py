"""PyTorch / CUDA port of langscenex-tpu.

The JAX package ``langscenex_tpu`` is the reference; this package mirrors
its module paths (``ops/``, ``scene/``, ``train/``) and its public layouts
([3,H,W] images, [P,3] per-splat rows, wxyz quaternions). Plain tensor
code is PyTorch; every TPU kernel on the ported path is a hand-written
CUDA kernel under ``csrc/``, built with nvcc for sm_90a the first time a
CUDA tensor reaches it (see ``_build.py``). Importing the package needs
neither nvcc nor a GPU.

Ported so far: the render path (``ops/{quat,transforms,sh,covariance,
projection,sort_engine,compaction,binning,rasterize_cuda,rasterize}.py``,
``scene/{gaussians,ply_io,cameras}.py``, ``train/field.render_view`` and
``train/render_mode.render_all_views``), the field-construction train
step (the blend backward, ``ops/{losses,depth_normal,interp,knn}.py``,
``utils/config.OptimizationConfig``, ``train/{optim,multiview,densify,
field}.py`` with ``GaussianFieldTrainer``) and the TriMap video-diffusion
request (``ops/{ln_modulate,flash_attention}.py`` over kernels K8 and K5,
``models/cogvideox/{transformer,scheduler,pipeline,vae}.py``,
``models/t5.py`` and ``video_inference.py``) and the field stage end to
end (``scene/{colmap_io,dataset_readers}.py``, ``ops/tsdf.py``,
``train/{render_mode,checkpoint,per_point_adam}.py``,
``eval/open_vocab.py``, ``pipeline.py`` and the train / render / eval
CLI ``entry_point.py``; images through ``utils/png.py``, no PIL).
Entry points run on the first CUDA card unless the caller names another
device (``utils/device.py``).
"""
