"""The example trainers (counterpart of the repository's examples/): eight
autoencoders on FashionMNIST-shaped images (synthetic blobs when no local
copy of the dataset exists), each `main(...)` returning the trained model
and runnable as `python -m vqtpu_torch.examples.<name> [--train_iter N]
[--device cpu]`, the shared loop in `common`, and two distributed
examples, run as torchrun jobs over gloo: `tp_large_codebook` (a
row-sharded 65,536-code codebook under TensorParallelTrainer) and
`group_parallel_grvq` (group_parallel_forward over a GroupedResidualVQ).

The submodules are not imported here: each is a script's module, loaded
by `python -m` or by name."""

AUTOENCODERS = ('autoencoder', 'autoencoder_lfq', 'autoencoder_fsq', 'autoencoder_sim_vq', 'autoencoder_rvq',
                'autoencoder_hq', 'autoencoder_fvq', 'autoencoder_fsp')
