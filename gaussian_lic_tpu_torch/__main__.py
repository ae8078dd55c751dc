from gaussian_lic_tpu_torch.run import main

if __name__ == "__main__":
    raise SystemExit(main())
