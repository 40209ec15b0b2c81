"""The numbers behind the pipeline tests' choice of references, measured
with the JAX package on the 8-device CPU mesh at fp32 (and the port on
the CPU):

- how far JAX's pipelined MoE loss is from its unpipelined loss
  (moe_debug, capacity factors 1.25 and 0.5): at data=2 x stage=2 x
  expert=2 the pipeline routes each global microbatch on its own; at
  data=2 x stage=2 x sequence=2 each sequence shard of it (why the port
  raises for MoE under stage and sequence together);
- after 3 steps of ``debug`` at data=2 x stage=2 x tensor=2 (4
  microbatches), the share of each leaf's elements farther than
  ``sharded_step_ref.params_close``'s 2e-7 + 1e-5·|b| apart between JAX's
  pipelined and unpipelined steps, and between the port's pipeline (run
  in one process) and JAX's unpipelined step (why params after
  pipelined steps are held against the unpipelined step).

    python tests/pipeline_numbers.py    # ~40 s on the CPU
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def moe_loss_offsets():
    import jax
    import jax.numpy as jnp

    import sharded_step_ref as R
    from ray_tpu.models import transformer as JT
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    toks = jnp.asarray(R.tokens(512))
    for spec in ({"data": 2, "stage": 2, "expert": 2}, {"data": 2, "stage": 2, "sequence": 2}):
        mesh = build_mesh(MeshSpec(**spec))
        for cf in (1.25, 0.5):
            cfg, _ = R.configs("moe_debug", capacity_factor=cf)
            params = JT.init_params(cfg, jax.random.key(0))
            whole = float(JT.loss_fn(cfg, params, {"tokens": toks})[0])
            with jax.set_mesh(mesh):
                piped = float(jax.jit(lambda p: JT.loss_fn(
                    cfg, p, {"tokens": toks}, mesh=mesh, num_microbatches=2)[0])(params))
            print(f"moe_debug {spec} cf {cf}: pipelined - unpipelined loss "
                  f"{piped - whole:+.4f}")


def params_noise():
    import jax
    import numpy as np

    import sharded_step_ref as R
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.train import step as JS

    jcfg, tcfg = R.configs("debug")
    opt = JS.default_optimizer(jcfg, lr=R.LR)
    mesh = build_mesh(MeshSpec(data=2, stage=2, tensor=2))
    jstate = JS.init_state(jcfg, opt, mesh, seed=0)
    batch = {"tokens": R.tokens(jcfg.vocab_size)}
    piped = R.jax_run(jcfg, mesh, jstate, batch, with_eval=False, num_microbatches=4)
    mesh8 = build_mesh(MeshSpec(data=8))
    whole = R.jax_run(jcfg, mesh8, jax.device_put(jstate, JS.state_shardings(jcfg, opt, mesh8)),
                      batch, with_eval=False)
    port = R.port_steps(tcfg, R.np_state(jstate), batch, num_microbatches=4, stages=2)

    def noisy(a, b):
        return float(np.mean(np.abs(a - b) > 2e-7 + 1e-5 * np.abs(b)))

    for path in ("blocks/wq", "blocks/wk", "blocks/wo", "embed"):
        b = whole["params"][path]
        print(f"{path}: JAX pipelined vs JAX unpipelined {noisy(piped['params'][path], b):.5f}, "
              f"port pipelined vs JAX unpipelined {noisy(port['params'][path], b):.5f}")


if __name__ == "__main__":
    moe_loss_offsets()
    params_noise()
