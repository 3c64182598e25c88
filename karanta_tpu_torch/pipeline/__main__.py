from karanta_tpu_torch.pipeline.runner import main

if __name__ == "__main__":
    main()
