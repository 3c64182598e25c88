from karanta_tpu_torch.training.train import main

if __name__ == "__main__":
    main()
