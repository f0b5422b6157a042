# Environment hook sourced by the job scripts — parity with the reference's
# env.sh:1-3 (empty placeholder for module loads / exports).  Put
# site-specific setup here, e.g.:
#   module load cuda
#   export JAX_COMPILATION_CACHE_DIR=/shared/jax-cache
