"""The multi-process runner: a (temperature shards x walker shards) mesh of
torch.distributed ranks running one tempered MALA fit (`run --mesh TxC`)."""
