"""radarml_tpu — a JAX radar perception framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
goruck/radar-ml (reference mounted at /root/reference): a Walabot-style
spherical scan arena produces 3-D return-signal cubes; three orthogonal
2-D projections (XZ, YZ, XY) sliced at target positions flow through
fused, batched resize/normalize/concat kernels into classifier families
(linear SGD/logistic, RBF-SVC, multi-view CNN, semi-supervised GAN),
trained and served with jit/pjit over device meshes.

Subpackages
-----------
core      arena geometry, coordinate transforms (reference common.py:25-121)
ops       batched resample/rotate/noise/feature kernels (XLA + Pallas)
data      dataset store, labels, balancing, splits, synthetic fixtures
models    linear, svc, cnn, sgan model families
train     fit harnesses: grid search, Adam loops, SGAN schedule, metrics
parallel  mesh construction + sharding specs for multi-chip scale-out
fusion    camera→radar coordinate fusion + target association
rpc       detection-server gRPC protocol client + in-process fake
drivers   radar session drivers (synthetic, replay, native C++, walabot)
viz       dataset browser, realtime capture view, dataset plots
utils     stage timers, rate meters, device traces
apps      CLI entry points mirroring the reference's public surface
"""

__version__ = "0.1.0"
