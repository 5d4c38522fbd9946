"""pbwt-tpu: a Positional Burrows-Wheeler Transform framework in JAX.

A from-scratch reimplementation of the capabilities of richarddurbin/pbwt
(Durbin, Bioinformatics 30:1266-72, 2014):

- exact host engine (numpy + optional C extension) producing bit-identical
  .pbwt files, match lists and VCF output to the reference CLI,
- a JAX/XLA device engine for large-scale construction, matching,
  imputation and painting (the default on a GPU), scaling over
  ``jax.sharding`` meshes.

Layer map (mirrors SURVEY.md section 1 of the reference):
  L5 CLI            pbwt_tpu.cli
  L4 algorithms     pbwt_tpu.algos.{match,impute,paint,likelihood,geneticmap,merge}
  L3 I/O            pbwt_tpu.io.{pbwtfile,vcf,bcf,textformats}
  L2 core engine    pbwt_tpu.core.{pbwt,engine,pack3}
  L1 device ops     pbwt_tpu.ops.{build,match_jax,impute_jax,paint_jax,likelihood_jax},
                    pbwt_tpu.parallel.{sharding,query_sharding}
"""

from .version import __version__, MAJOR_VERSION, MINOR_VERSION
from .core.pbwt import PBWT, Site
from .core import registry

__all__ = ["PBWT", "Site", "registry", "__version__", "MAJOR_VERSION", "MINOR_VERSION"]
