from mridc_tpu_torch.cli import main

main()
