from audio_analysis_tpu_torch.cli.analyse_cli import main

if __name__ == "__main__":
    main()
