from tinygpt_tpu_torch.server.http import main

if __name__ == "__main__":
    main()
