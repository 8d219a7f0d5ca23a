"""`python -m hite_tpu_torch --genome g.fa --out_dir o ...`: the CLI."""

from hite_tpu_torch.pipeline.run import main

main()
